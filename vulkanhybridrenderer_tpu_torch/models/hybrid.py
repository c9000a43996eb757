"""Hybrid render path (port of ``models/hybrid.py``).

  Geometry -> G-Buffer Pass -> [BVH -> Raytrace Pass -> [SVGF Denoise Pass]]
           -> Composition Pass

The BVH and the Raytrace Pass are registered when any of shadows, AO or
reflections is RAYTRACED; the SVGF Denoise Pass when denoise is on as well.
It reads and returns the temporal state ("temporal_state" in,
"TemporalStateOut" out), which the renderer carries to the next frame.  The
rasterized shadow map, SSAO, SSR (item 13) and half-resolution RT (item 12)
raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

from vulkanhybridrenderer_tpu_torch.core.config import (
    AmbientOcclusionMode,
    ReflectionMode,
    ShadowMode,
)
from vulkanhybridrenderer_tpu_torch.core.types import GBuffer
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT, RenderGraph
from vulkanhybridrenderer_tpu_torch.models.base import RenderPath
from vulkanhybridrenderer_tpu_torch.models.passes import (
    add_bvh_pass,
    add_geometry_pass,
    check_raster_supported,
    rasterize_for_path,
)
from vulkanhybridrenderer_tpu_torch.ops import composition, gbuffer, raygen, svgf

ALBEDO = "Albedo"
NORMALS = "World Space Normals and Object IDs"
MOTION_MR = "Motion Vectors and Metallic Roughness"
DEPTH = "Depth"
RT_SHADOW_AO = "Raytraced Shadows and Ambient Occlusion"
RT_REFLECTIONS = "Raytraced Reflections"
DENOISED = "Denoised Raytraced Shadows and Ambient Occlusion"


class HybridPath(RenderPath):
    name = "hybrid"

    def __init__(self, config):
        super().__init__(config)
        check_raster_supported(config)
        composition.check_supported(config.hybrid)
        raygen.check_supported(config.hybrid)
        if config.shadow_accel != "bvh8":
            raise NotImplementedError("the shadow grid: ROADMAP item 16")

    def _rt_needed(self) -> bool:
        s = self.config.hybrid
        return (s.shadow_mode == ShadowMode.RAYTRACED
                or s.ao_mode == AmbientOcclusionMode.RAYTRACED
                or s.reflection_mode == ReflectionMode.RAYTRACED)

    @property
    def uses_temporal_state(self) -> bool:
        return self.config.hybrid.denoise and self._rt_needed()

    def register(self, graph: RenderGraph) -> None:
        cfg = self.config
        s = cfg.hybrid
        h, w = cfg.height, cfg.width

        add_geometry_pass(graph)

        def gbuffer_pass(res):
            vis = rasterize_for_path(res["scene"], res["Clip"], w, h, cfg,
                                     tables=res["shade_tables"])
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
        comp_sources = {}
        if self._rt_needed():
            add_bvh_pass(graph, cfg.animated)

            def raytrace_pass(res):
                shadow_ao, refl = raygen.hybrid_raytrace(
                    res["scene"], res["shade_tables"], res["TriRows"], res["BVH"],
                    res["pfd"], res[DEPTH], res[NORMALS], ao_rays=cfg.ao_rays,
                    settings=s,
                )
                return {RT_SHADOW_AO: shadow_ao, RT_REFLECTIONS: refl}

            graph.add_pass(
                "Raytrace Pass", raytrace_pass,
                inputs=("scene", "shade_tables", "TriRows", "pfd", "BVH", DEPTH, NORMALS),
                outputs=(RT_SHADOW_AO, RT_REFLECTIONS),
            )
            comp_sources["rt_shadow_ao"] = RT_SHADOW_AO
            if s.reflection_mode == ReflectionMode.RAYTRACED:
                comp_sources["rt_reflections"] = RT_REFLECTIONS

        if self.uses_temporal_state:
            def svgf_pass(res):
                denoised, new_state = svgf.denoise(
                    res[NORMALS], res[MOTION_MR], res[RT_SHADOW_AO], res["temporal_state"]
                )
                return {DENOISED: denoised, "TemporalStateOut": new_state}

            graph.add_pass(
                "SVGF Denoise Pass", svgf_pass,
                inputs=(NORMALS, MOTION_MR, RT_SHADOW_AO, "temporal_state"),
                outputs=(DENOISED, "TemporalStateOut"),
            )
            comp_sources["rt_shadow_ao"] = DENOISED
        comp_inputs += comp_sources.values()

        def composition_pass(res):
            gb = GBuffer(albedo=res[ALBEDO], normal_oid=res[NORMALS],
                         motion_mr=res[MOTION_MR], depth=res[DEPTH])
            kwargs = {k: res[v] for k, v in comp_sources.items()}
            return {RENDER_OUTPUT: composition.compose(gb, res["pfd"], s, **kwargs)}

        graph.add_pass(
            "Composition Pass", composition_pass,
            inputs=tuple(comp_inputs), outputs=(RENDER_OUTPUT,),
        )
