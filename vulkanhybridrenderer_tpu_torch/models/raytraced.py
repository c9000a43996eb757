"""Full ray-traced render path (reference raytraced_render_path.cpp:11-76;
port of ``models/raytraced.py``).

Passes: Geometry -> BVH -> Raytrace Pass (primary rays, closest-hit shading,
one shadow ray per hit) -> Composition (the blit to RENDER_OUTPUT).

Primary rays are raygen.rgen:11-20: origin = view_inverse @ (0, 0, 0, 1),
direction = view_inverse @ normalize(proj_inverse @ (ndc.xy, 1, 1)).xyz,
tmin 0.1, tmax 10000, traced closest-hit through K2.  Shadow rays go from
the hit position toward the light, tmin 0.1, any-hit.  A miss is the sky
(0.3, 0.8, 0.2, 1) (miss.rmiss:7).

``RaytracedSettings.test_alpha`` is the any-hit variant pipeline
(raygen_test_alpha / closesthit_test_alpha / shadow_anyhit): both wavefronts
go through K2's alpha any-hit filter when the scene has masked materials,
and the hit shader takes its other constants.  The reference's tilers,
strips and packets have no counterpart: one GPU thread traces one ray.
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT, RenderGraph
from vulkanhybridrenderer_tpu_torch.models.base import RenderPath
from vulkanhybridrenderer_tpu_torch.models.passes import add_bvh_pass, add_geometry_pass
from vulkanhybridrenderer_tpu_torch.ops import rt_shade, screen, traverse
from vulkanhybridrenderer_tpu_torch.utils.consts import device_constant
from vulkanhybridrenderer_tpu_torch.utils.math3d import (
    normalize,
    transform_directions,
    transform_points,
)

SKY = (0.3, 0.8, 0.2, 1.0)  # miss.rmiss:7
PRIMARY_TMIN = 0.1
SHADOW_TMIN = 0.1
TMAX = 10000.0
OUTPUT = "Raytraced Output"


def primary_rays(pfd, height: int, width: int):
    """raygen.rgen:11-18: origins and directions, (H * W, 3) each, in image
    order."""
    uv = screen.pixel_uv_grid(height, width, device=pfd.camera_view.device).reshape(-1, 2)
    ndc = uv * 2.0 - 1.0
    target = transform_points(pfd.camera_proj_inverse,
                              torch.cat([ndc, torch.ones_like(ndc[:, :1])], dim=-1))
    d_world = transform_directions(pfd.camera_view_inverse, normalize(target[:, :3]))
    origin = pfd.camera_view_inverse[:3, 3].expand(d_world.shape)
    return origin.contiguous(), d_world.contiguous()


class RaytracedPath(RenderPath):
    name = "raytraced"

    def register(self, graph: RenderGraph) -> None:
        cfg = self.config
        h, w = cfg.height, cfg.width
        test_alpha = cfg.raytraced.test_alpha

        add_geometry_pass(graph)
        add_bvh_pass(graph, cfg.animated)

        def raytrace_pass(res):
            scene, pfd, bvh, tables = res["scene"], res["pfd"], res["BVH"], res["shade_tables"]
            # the filter changes nothing on a scene without masked materials
            alpha = tables if test_alpha and scene.has_alpha_mask else None
            o, d = primary_rays(pfd, h, w)
            rec = traverse.trace(bvh, None, o, d, PRIMARY_TMIN, TMAX, alpha_tables=alpha)
            pos = rt_shade.interpolate_hit_attributes(
                tables, res["TriRows"], rec.tri, rec.u, rec.v)["position"]
            # a missed primary ray shows the sky: its shadow ray is dead
            sh_tmax = torch.where(rec.hit, TMAX, -1.0)
            sh_dir = (-pfd.directional_light.direction[:3]).expand(pos.shape).contiguous()
            shadow = traverse.trace(bvh, None, pos.contiguous(), sh_dir, SHADOW_TMIN, sh_tmax,
                                    anyhit=True, alpha_tables=alpha)
            shaded = rt_shade.primary_hit_shade(
                scene, tables, res["TriRows"], pfd, rec.tri, rec.u, rec.v, ~shadow.hit,
                test_alpha=test_alpha,
            )
            sky = device_constant(SKY, device=shaded.device)
            img = torch.where(rec.hit[:, None], shaded, sky)
            return {OUTPUT: img.reshape(h, w, 4).permute(2, 0, 1).contiguous()}

        graph.add_pass(
            "Raytrace Pass", raytrace_pass,
            inputs=("scene", "pfd", "BVH", "shade_tables", "TriRows"), outputs=(OUTPUT,),
        )
        graph.add_pass("Composition", lambda res: {RENDER_OUTPUT: res[OUTPUT]},
                       inputs=(OUTPUT,), outputs=(RENDER_OUTPUT,))
