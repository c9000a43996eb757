"""Forward raster path (forward_raster_render_path.cpp:11-96; port of
``models/forward.py``).

  Geometry -> Depth Prepass (the shadow map) -> Forward Pass -> RENDER_OUTPUT

The Forward Pass reads the shadow map, as the reference's does, though the
reference's shader then overrides the lookup with shadow = 1.0; the prepass
still runs every frame, so the frame does the reference's work.

MSAA (forward_raster_render_path.cpp:59, the max-sample-count attachments):
  * "coverage" (the default, for 2, 4 or 8 samples): depth and coverage per
    sample at the standard Vulkan positions (rasterize_scene_msaa, K1d);
    each pixel shades its sample-0 fragment and at most one other distinct
    fragment (the first sample whose triangle differs), and the resolve
    averages the samples' colors: a sample on sample 0's triangle takes its
    color, one on another triangle the second fragment's, an uncovered one
    the clear color 0;
  * "supersample" (and every sample count with ``raster="brute"``, as in
    the reference): raster and shade at isqrt(k) times the resolution per
    axis, then a box filter (k = 2 gives 1x, 4 and 8 give 2x);
  * one sample: the plain raster.
"""
from __future__ import annotations

import math

import torch

from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT, RenderGraph
from vulkanhybridrenderer_tpu_torch.models.base import RenderPath
from vulkanhybridrenderer_tpu_torch.models.passes import (
    add_geometry_pass,
    add_shadow_map_pass,
    rasterize_for_path,
)
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled, shade
from vulkanhybridrenderer_tpu_torch.ops.rasterizer import VisibilityBuffer


class ForwardRasterPath(RenderPath):
    name = "forward"

    def register(self, graph: RenderGraph) -> None:
        cfg = self.config
        k = max(1, cfg.forward.msaa_samples)
        coverage = cfg.forward.msaa_mode == "coverage" and k > 1 and cfg.raster == "binned"
        ss = 1 if coverage else max(1, math.isqrt(k))
        w, h = cfg.width * ss, cfg.height * ss

        add_geometry_pass(graph)
        add_shadow_map_pass(graph, cfg.shadow_map_size, cfg)

        def shade_vis(res, vis):
            attrs = shade.resolve_forward_attributes(
                res["scene"], res["shade_tables"], res["TriRows"], vis)
            return shade.forward_shade(attrs, res["pfd"], shadow=None)

        def forward_pass(res):
            scene = res["scene"]
            if coverage:
                if res.get("mesh") is not None:
                    raise NotImplementedError(
                        "coverage MSAA is single-device; use "
                        "forward.msaa_mode='supersample' on a mesh"
                    )
                vises = rasterizer_tiled.rasterize_scene_msaa(
                    scene, res["Clip"], w, h, k, alpha=cfg.alpha_raster != "off",
                    cull_backface=cfg.raster_state.cull_mode == "back",
                    tables=res["shade_tables"],
                )
                v0 = vises[0]
                found = torch.zeros_like(v0.tri_id, dtype=torch.bool)
                tb, db, bb = v0.tri_id, v0.depth, v0.bary
                for v in vises[1:]:
                    take = ~found & (v.tri_id != v0.tri_id) & (v.tri_id >= 0)
                    tb = torch.where(take, v.tri_id, tb)
                    db = torch.where(take, v.depth, db)
                    bb = torch.where(take[..., None], v.bary, bb)
                    found |= take
                col_a = shade_vis(res, v0)
                col_b = shade_vis(res, VisibilityBuffer(tri_id=tb, depth=db, bary=bb))
                acc = torch.zeros_like(col_a)
                for v in vises:
                    ci = torch.where((v.tri_id == v0.tri_id)[None], col_a, col_b)
                    ci = torch.where((v.tri_id == -1)[None], 0.0, ci)
                    acc = acc + ci
                return {RENDER_OUTPUT: acc / k}

            vis = rasterize_for_path(scene, res["Clip"], w, h, cfg, mesh=res.get("mesh"),
                                     tables=res["shade_tables"])
            img = shade_vis(res, vis)
            if ss > 1:  # the supersample resolve: a box filter
                img = img.reshape(img.shape[0], cfg.height, ss, cfg.width, ss).mean(dim=(2, 4))
            return {RENDER_OUTPUT: img}

        graph.add_pass(
            "Forward Pass", forward_pass,
            inputs=("scene", "pfd", "Clip", "Shadow Map", "shade_tables", "TriRows"),
            outputs=(RENDER_OUTPUT,),
        )
