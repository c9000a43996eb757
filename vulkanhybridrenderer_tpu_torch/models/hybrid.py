"""Hybrid render path (port of ``models/hybrid.py``), RT-shadow slice.

  Geometry -> G-Buffer Pass -> [BVH -> Raytrace Pass] -> Composition Pass

The Raytrace Pass (and the BVH it reads) is registered when shadows are
RAYTRACED; with shadows OFF composition lights every pixel.  The other
modes raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

from vulkanhybridrenderer_tpu_torch.core.config import ShadowMode
from vulkanhybridrenderer_tpu_torch.core.types import GBuffer
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT, RenderGraph
from vulkanhybridrenderer_tpu_torch.models.base import RenderPath
from vulkanhybridrenderer_tpu_torch.models.passes import (
    add_bvh_pass,
    add_geometry_pass,
    check_raster_supported,
    rasterize_for_path,
)
from vulkanhybridrenderer_tpu_torch.ops import composition, gbuffer, raygen

ALBEDO = "Albedo"
NORMALS = "World Space Normals and Object IDs"
MOTION_MR = "Motion Vectors and Metallic Roughness"
DEPTH = "Depth"
RT_SHADOW_AO = "Raytraced Shadows and Ambient Occlusion"
RT_REFLECTIONS = "Raytraced Reflections"


class HybridPath(RenderPath):
    name = "hybrid"

    def __init__(self, config):
        super().__init__(config)
        check_raster_supported(config)
        composition.check_supported(config.hybrid)
        raygen.check_supported(config.hybrid)
        if config.shadow_accel != "bvh8":
            raise NotImplementedError("the shadow grid: ROADMAP item 16")

    def register(self, graph: RenderGraph) -> None:
        cfg = self.config
        s = cfg.hybrid
        h, w = cfg.height, cfg.width
        rt_shadows = s.shadow_mode == ShadowMode.RAYTRACED

        add_geometry_pass(graph)

        def gbuffer_pass(res):
            vis = rasterize_for_path(res["scene"], res["Clip"], w, h, cfg)
            gb = gbuffer.resolve_gbuffer(
                res["scene"], res["shade_tables"], res["TriRows"], vis, res["pfd"]
            )
            return {ALBEDO: gb.albedo, NORMALS: gb.normal_oid,
                    MOTION_MR: gb.motion_mr, DEPTH: gb.depth}

        graph.add_pass(
            "G-Buffer Pass", gbuffer_pass,
            inputs=("scene", "pfd", "Clip", "shade_tables", "TriRows"),
            outputs=(ALBEDO, NORMALS, MOTION_MR, DEPTH),
        )

        comp_inputs = ["pfd", ALBEDO, NORMALS, MOTION_MR, DEPTH]
        if rt_shadows:
            add_bvh_pass(graph, cfg.animated)

            def raytrace_pass(res):
                shadow_ao, refl = raygen.hybrid_raytrace(
                    res["BVH"], res["pfd"], res[DEPTH], res[NORMALS], s
                )
                return {RT_SHADOW_AO: shadow_ao, RT_REFLECTIONS: refl}

            graph.add_pass(
                "Raytrace Pass", raytrace_pass,
                inputs=("pfd", "BVH", DEPTH, NORMALS),
                outputs=(RT_SHADOW_AO, RT_REFLECTIONS),
            )
            comp_inputs.append(RT_SHADOW_AO)

        def composition_pass(res):
            gb = GBuffer(albedo=res[ALBEDO], normal_oid=res[NORMALS],
                         motion_mr=res[MOTION_MR], depth=res[DEPTH])
            return {RENDER_OUTPUT: composition.compose(
                gb, res["pfd"], s, rt_shadow_ao=res.get(RT_SHADOW_AO)
            )}

        graph.add_pass(
            "Composition Pass", composition_pass,
            inputs=tuple(comp_inputs), outputs=(RENDER_OUTPUT,),
        )
