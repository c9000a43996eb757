"""Ray-query render path (reference rayquery_render_path.cpp:11-54; port of
``models/rayquery.py``).

A forward raster pass whose per-pixel shading casts an inline shadow ray
(rayquery default.frag:36-44): origin the world position, direction toward
the light, tmin 0.1, tmax 10000, terminate on first hit, opaque only (the
BLAS is opaque-flagged and the empty rayQueryProceed loop confirms no
non-opaque candidate, so no alpha test anywhere).  The raster is
``rasterize_for_path(alpha=False)`` (K1a, or the brute rasterizer with
``raster="brute"``), the shadow rays K2 any-hit.  Shading:
0.2 * albedo ambient + N.L * albedo * light color * visibility.
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT, RenderGraph
from vulkanhybridrenderer_tpu_torch.models.base import RenderPath
from vulkanhybridrenderer_tpu_torch.models.passes import (
    add_bvh_pass,
    add_geometry_pass,
    rasterize_for_path,
)
from vulkanhybridrenderer_tpu_torch.ops import shade, traverse

SHADOW_TMIN = 0.1
SHADOW_TMAX = 10000.0


class RayqueryPath(RenderPath):
    name = "rayquery"

    def register(self, graph: RenderGraph) -> None:
        cfg = self.config
        h, w = cfg.height, cfg.width

        add_geometry_pass(graph)
        add_bvh_pass(graph, cfg.animated)

        def rayquery_pass(res):
            scene, pfd = res["scene"], res["pfd"]
            # no alpha discard in the rayquery fragment shader (default.frag)
            vis = rasterize_for_path(scene, res["Clip"], w, h, cfg, alpha=False,
                                     mesh=res.get("mesh"))
            attrs = shade.resolve_forward_attributes(scene, res["shade_tables"],
                                                     res["TriRows"], vis)
            origins = attrs["position"].reshape(-1, 3).contiguous()
            dirs = (-pfd.directional_light.direction[:3]).expand(origins.shape).contiguous()
            # a pixel without a triangle shades to 0: its shadow ray is dead
            tmax = torch.where(attrs["valid"].reshape(-1), SHADOW_TMAX, -1.0)
            rec = traverse.trace(res["BVH"], None, origins, dirs, SHADOW_TMIN, tmax, anyhit=True)
            in_shadow = torch.where(rec.hit, 0.0, 1.0).reshape(h, w)
            return {RENDER_OUTPUT: shade.rayquery_shade(attrs, pfd, in_shadow)}

        graph.add_pass(
            "Rayquery Pass", rayquery_pass,
            inputs=("scene", "pfd", "Clip", "BVH", "shade_tables", "TriRows"),
            outputs=(RENDER_OUTPUT,),
        )
