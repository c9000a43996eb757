"""Hybrid render path (port of ``models/hybrid.py``).

  Geometry -> G-Buffer Pass -> [Depth Prepass] -> [BVH -> Raytrace Pass]
           -> [SSAO Pass -> SSAO Blur Pass] -> [SSR Pass]
           -> [SVGF Denoise Pass] -> Composition Pass

The Depth Prepass (the shadow map) is registered when shadows are
RASTERIZED; the BVH and the Raytrace Pass when any of shadows, AO or
reflections is RAYTRACED; the SSAO passes when AO is SSAO; the SSR Pass when
reflections are SSR; the SVGF Denoise Pass when denoise is on and something
is traced.  SVGF reads and returns the temporal state ("temporal_state" in,
"TemporalStateOut" out), which the renderer carries to the next frame.
Half-resolution RT (item 12) raises NotImplementedError naming its ROADMAP
item.
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
    add_shadow_map_pass,
    check_raster_supported,
    rasterize_for_path,
)
from vulkanhybridrenderer_tpu_torch.ops import composition, gbuffer, raygen, ssao, ssr, svgf

ALBEDO = "Albedo"
NORMALS = "World Space Normals and Object IDs"
MOTION_MR = "Motion Vectors and Metallic Roughness"
DEPTH = "Depth"
RT_SHADOW_AO = "Raytraced Shadows and Ambient Occlusion"
RT_REFLECTIONS = "Raytraced Reflections"
DENOISED = "Denoised Raytraced Shadows and Ambient Occlusion"
SHADOW_MAP = "Shadow Map"
SSAO_RAW = "Screen Space Ambient Occlusion Raw"
SSAO = "Screen Space Ambient Occlusion"
SSR = "Screen Space Reflections"


class HybridPath(RenderPath):
    name = "hybrid"

    def __init__(self, config):
        super().__init__(config)
        check_raster_supported(config)
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
        if s.shadow_mode == ShadowMode.RASTERIZED:
            add_shadow_map_pass(graph, cfg.shadow_map_size, cfg)
            comp_sources["shadow_map"] = SHADOW_MAP

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

        if s.ao_mode == AmbientOcclusionMode.SSAO:
            graph.add_pass(
                "SSAO Pass",
                lambda res: {SSAO_RAW: ssao.ssao(res["pfd"], res[DEPTH], res[NORMALS],
                                                 radius=s.ssao.radius)},
                inputs=("pfd", DEPTH, NORMALS), outputs=(SSAO_RAW,),
            )
            graph.add_pass(
                "SSAO Blur Pass", lambda res: {SSAO: ssao.ssao_blur(res[SSAO_RAW])},
                inputs=(SSAO_RAW,), outputs=(SSAO,),
            )
            comp_sources["ssao_tex"] = SSAO

        if s.reflection_mode == ReflectionMode.SSR:
            graph.add_pass(
                "SSR Pass",
                lambda res: {SSR: ssr.ssr(res["pfd"], res[DEPTH], res[NORMALS], res[ALBEDO],
                                          res[MOTION_MR], s.ssr)},
                inputs=("pfd", DEPTH, NORMALS, ALBEDO, MOTION_MR), outputs=(SSR,),
            )
            comp_sources["ssr_tex"] = SSR

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
