"""Ray-hit shading (port of ``ops/rt_shade.py``).

The closest-hit shaders as batched gathers and BRDF math; a hit's attributes
come from one TriRow gather blended by the hit barycentrics.
  reflection_hit_shade - reflection_hit.rchit:10-72: ambient (PI_INV * 0.2)
      plus GGX direct lighting, unshadowed (the reference's shadow trace
      there is commented out);
  primary_hit_shade - the full-RT path's closesthit.rchit:26-67 (and
      closesthit_test_alpha.rchit's constants), lit by its shadow ray.
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.core.types import PerFrameData
from vulkanhybridrenderer_tpu_torch.ops import brdf, shadetab
from vulkanhybridrenderer_tpu_torch.ops.gbuffer import apply_normal_map
from vulkanhybridrenderer_tpu_torch.utils.math3d import PI_INVERSE, dot, normalize


def interpolate_hit_attributes(tables, tri_rows, tri, u, v):
    """Barycentric attribute fetch for hit records (tri == -1 reads row 0;
    the caller masks misses).  Returns dict(prim, uv, normal (object
    space), tangent, position (world), pm (the material fields))."""
    tr = shadetab.fetch_tri(tri_rows, torch.clamp(tri, min=0))
    wts = torch.stack([1.0 - u - v, u, v], dim=-1)
    return dict(
        prim=tr["prim"],
        uv=shadetab.interpolate3(tr["uv0"], wts),
        normal=shadetab.interpolate3(tr["normal"], wts),
        tangent=shadetab.interpolate3(tr["tangent"], wts),
        position=shadetab.interpolate3(tr["pos"], wts),
        pm=tr,
    )


def reflection_hit_shade(scene, tables, tri_rows, pfd: PerFrameData, tri, u, v):
    """reflection_hit.rchit:26-71.  Returns (R, 4) rgba; the caller zeroes
    misses (reflection_miss.rmiss)."""
    at = interpolate_hit_attributes(tables, tri_rows, tri, u, v)
    pm = at["pm"]
    albedo = shadetab.sample_atlas4(
        tables, pm["base_tex"], pm["base_scale"], pm["base_offset"], at["uv"],
        fallback=pm["base_color"],
    )[..., :3]
    if scene.has_mr_textures:
        mr = shadetab.sample_atlas4(
            tables, pm["mr_tex"], pm["mr_scale"], pm["mr_offset"], at["uv"]
        )
        has_mr = pm["mr_tex"] >= 0
        metallic = pm["metallic"] * torch.where(has_mr, mr[..., 1], 1.0)
        roughness = pm["roughness"] * torch.where(has_mr, mr[..., 2], 1.0)
    else:
        metallic = pm["metallic"]
        roughness = pm["roughness"]

    v_dir = normalize(pfd.camera_position - at["position"])
    # the reference lights with the raw interpolated object-space normal
    # (reflection_hit.rchit:18, 57)
    n = at["normal"]
    l = (-pfd.directional_light.direction[:3]).expand(n.shape)
    lighting = brdf.direct_lighting(
        albedo, metallic, roughness, n, v_dir, l,
        pfd.directional_light.color[:3], pfd.directional_light.intensity[:3],
        ambient_factor=PI_INVERSE * 0.2,
    )
    return torch.cat([lighting, torch.ones_like(lighting[..., :1])], dim=-1)


def primary_hit_shade(scene, tables, tri_rows, pfd: PerFrameData, tri, u, v, lit,
                      test_alpha: bool = False):
    """closesthit.rchit:26-67: albedo / pi ambient plus, where the shadow ray
    missed (`lit`, (R,) bool), N.L * albedo * intensity * color, with the
    object-space normal map (:37-46).  test_alpha switches to
    closesthit_test_alpha.rchit's constants: ambient 0.2 * albedo and no
    intensity in the direct term (:39, :46).  Returns (R, 4) rgba."""
    at = interpolate_hit_attributes(tables, tri_rows, tri, u, v)
    pm = at["pm"]
    albedo = shadetab.sample_atlas4(
        tables, pm["base_tex"], pm["base_scale"], pm["base_offset"], at["uv"],
        fallback=pm["base_color"],
    )[..., :3]
    n = at["normal"]
    if scene.has_normal_maps:
        ts = shadetab.sample_atlas4(
            tables, pm["nm_tex"], pm["nm_scale"], pm["nm_offset"], at["uv"]
        )[..., :3]
        n = apply_normal_map(n, at["tangent"], pm["nm_tex"], ts)

    light = pfd.directional_light
    n_dot_l = torch.clamp(dot(n, -light.direction[:3]), min=0.0)
    if test_alpha:
        ambient = 0.2 * albedo
        direct = albedo * n_dot_l[..., None] * light.color[:3]
    else:
        ambient = PI_INVERSE * albedo
        direct = albedo * n_dot_l[..., None] * light.intensity[:3] * light.color[:3]
    rgb = ambient + torch.where(lit[..., None], direct, 0.0)
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
