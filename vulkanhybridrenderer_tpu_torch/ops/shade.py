"""Per-pixel shading of the forward and ray-query paths (port of
``ops/shade.py``): forward_raster_render_path's default.frag and
rayquery_render_path's default.frag.

The reference's forward shaders interpolate object-space normals (default.
vert:26 passes in_normal straight through, no normal matrix); kept.
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.core.types import PerFrameData, SceneBuffers
from vulkanhybridrenderer_tpu_torch.ops import shadetab
from vulkanhybridrenderer_tpu_torch.ops.gbuffer import apply_normal_map
from vulkanhybridrenderer_tpu_torch.ops.rasterizer import VisibilityBuffer, weights_from_bary
from vulkanhybridrenderer_tpu_torch.utils.math3d import PI_INVERSE, dot


def resolve_forward_attributes(scene: SceneBuffers, tables, tri_rows,
                               vis: VisibilityBuffer) -> dict:
    """The attributes the forward fragment shader reads, per pixel: validity,
    primitive, uv, object-space (normal-mapped) normal, world position and
    albedo, from one TriRow gather and one atlas quad row per sample."""
    valid = vis.tri_id >= 0
    tr = shadetab.fetch_tri(tri_rows, torch.clamp(vis.tri_id, min=0))
    wts = weights_from_bary(vis.bary)
    uv = shadetab.interpolate3(tr["uv0"], wts)
    n_obj = shadetab.interpolate3(tr["normal"], wts)
    albedo = shadetab.sample_atlas4(
        tables, tr["base_tex"], tr["base_scale"], tr["base_offset"], uv,
        fallback=tr["base_color"],
    )
    if scene.has_normal_maps:  # default.frag:62-69
        ts = shadetab.sample_atlas4(
            tables, tr["nm_tex"], tr["nm_scale"], tr["nm_offset"], uv
        )[..., :3]
        n = apply_normal_map(n_obj, shadetab.interpolate3(tr["tangent"], wts),
                             tr["nm_tex"], ts)
    else:
        n = n_obj
    return dict(valid=valid, prim=tr["prim"], uv=uv, normal=n,
                position=shadetab.interpolate3(tr["pos"], wts), albedo=albedo)


def forward_shade(attrs: dict, pfd: PerFrameData, shadow=None):
    """default.frag:71-85: albedo / pi + albedo * max(N.L, 0) * light color;
    (4, H, W) linear, clear color 0.  `shadow` would scale the diffuse term,
    but the reference overrides its lookup with shadow = 1.0 (default.frag:
    79): pass None for that."""
    l = -pfd.directional_light.direction[:3]
    n_dot_l = torch.clamp(dot(attrs["normal"], l), min=0.0)
    s = 1.0 if shadow is None else shadow
    albedo = attrs["albedo"][..., :3]
    ambient = albedo * PI_INVERSE
    diffuse = albedo * (n_dot_l * s)[..., None] * pfd.directional_light.color[:3]
    valid = attrs["valid"]
    rgb = torch.where(valid[..., None], ambient + diffuse, 0.0)
    a = torch.where(valid, 1.0, 0.0)
    return torch.cat([rgb, a[..., None]], dim=-1).permute(2, 0, 1).contiguous()


def rayquery_shade(attrs: dict, pfd: PerFrameData, in_shadow):
    """rayquery default.frag:71-85: 0.2 * albedo + N.L * albedo * light color
    * visibility; in_shadow (H, W) is 1.0 where the inline shadow query
    missed, else 0.0.  (4, H, W) linear, clear color 0."""
    l = -pfd.directional_light.direction[:3]
    n_dot_l = torch.clamp(dot(attrs["normal"], l), min=0.0)
    albedo = attrs["albedo"][..., :3]
    diffuse = albedo * (n_dot_l * in_shadow)[..., None] * pfd.directional_light.color[:3]
    valid = attrs["valid"]
    rgb = torch.where(valid[..., None], 0.2 * albedo + diffuse, 0.0)
    a = torch.where(valid, 1.0, 0.0)
    return torch.cat([rgb, a[..., None]], dim=-1).permute(2, 0, 1).contiguous()
