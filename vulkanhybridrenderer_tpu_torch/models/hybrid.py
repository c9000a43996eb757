"""Hybrid render path (port of ``models/hybrid.py``).

  Geometry -> G-Buffer Pass -> [Depth Prepass]
           -> [BVH | Shadow Grid Build -> Raytrace Pass]
           -> [SSAO Pass -> SSAO Blur Pass] -> [SSR Pass]
           -> [SVGF Denoise Pass] -> Composition Pass

The Depth Prepass (the shadow map) is registered when shadows are
RASTERIZED; the Raytrace Pass when any of shadows, AO or reflections is
RAYTRACED, and the BVH pass ("BVH Refit" when animated) with it unless only
the shadows are traced and ``shadow_accel="grid"``: the Shadow Grid Build
pass then brings the light-space grid instead (the renderer's prebuilt one,
or rebuilt from this frame's world triangles when animated); the SSAO
passes when AO is SSAO; the SSR Pass when reflections are SSR; the SVGF
Denoise Pass when denoise is on and something is traced.  SVGF reads and returns the temporal state ("temporal_state" in,
"TemporalStateOut" out), which the renderer carries to the next frame.

With ``rt_scale = s > 1`` the RT Downsample Pass point-samples depth, normals
and motion to 1/s resolution, the Raytrace Pass and SVGF run there, and the
RT Upsample Pass brings the (denoised) shadows / AO and the reflections back
to full resolution, weighted by the full-resolution G-buffer
(ops/upsample.py).

Every pass after the geometry, the BVH, the shadow grid and the
shadow-map prepass is registered as Steps (graph/render_graph.py), each
declaring how it reads its images: by its own rows, with a halo, or whole.
On one device they run over every row (``rows`` None); over a device mesh
(parallel/mesh.py) once per shard over its row slab.  The G-Buffer Pass is
the raster, then the resolve, which over a mesh resolves the sort-last
raster's bands where they lie; SVGF is svgf.denoise_steps: its temporal
stage, then each a-trous iteration, after a halo exchange of 2 s rows over a
mesh.
"""
from __future__ import annotations

from vulkanhybridrenderer_tpu_torch.core.config import (
    AmbientOcclusionMode,
    ReflectionMode,
    ShadowMode,
)
from vulkanhybridrenderer_tpu_torch.core.types import GBuffer
from vulkanhybridrenderer_tpu_torch.graph.render_graph import (
    RENDER_OUTPUT,
    ROWS,
    WHOLE,
    RenderGraph,
    Step,
    halo,
)
from vulkanhybridrenderer_tpu_torch.models.base import RenderPath
from vulkanhybridrenderer_tpu_torch.models.passes import (
    add_bvh_pass,
    add_geometry_pass,
    add_shadow_map_pass,
    raster_steps,
)
from vulkanhybridrenderer_tpu_torch.ops import (
    composition,
    gbuffer,
    raygen,
    shadowgrid,
    ssao,
    ssr,
    svgf,
    upsample,
)

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
RT_DEPTH = "RT Depth"
RT_NORMALS = "RT Normals"
RT_MOTION = "RT Motion"
UP_SHADOW_AO = "Upsampled Raytraced Shadows and Ambient Occlusion"
UP_REFLECTIONS = "Upsampled Raytraced Reflections"
SHADOW_GRID = "ShadowGrid"


class HybridPath(RenderPath):
    name = "hybrid"

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

        def resolve(res, vis):
            gb = gbuffer.resolve_gbuffer(res["scene"], res["shade_tables"], res["TriRows"],
                                         vis, res["pfd"], rows=res["rows"])
            return {ALBEDO: gb.albedo, NORMALS: gb.normal_oid,
                    MOTION_MR: gb.motion_mr, DEPTH: gb.depth}

        graph.add_pass(
            "G-Buffer Pass",
            raster_steps(w, h, cfg, resolve),
            inputs=("scene", "pfd", "Clip", "shade_tables", "TriRows"),
            outputs=(ALBEDO, NORMALS, MOTION_MR, DEPTH),
        )

        comp_inputs = ["pfd", ALBEDO, NORMALS, MOTION_MR, DEPTH]
        comp_sources = {}
        if s.shadow_mode == ShadowMode.RASTERIZED:
            add_shadow_map_pass(graph, cfg.shadow_map_size, cfg)
            comp_sources["shadow_map"] = SHADOW_MAP

        rs = max(1, s.rt_scale)
        rt_half = self._rt_needed() and rs > 1
        if rt_half:
            def downsample_pass(res):
                # a slab's first row is a multiple of rs (Step.scale), so
                # its samples are the whole image's
                return {RT_DEPTH: upsample.downsample_nearest(res[DEPTH], rs),
                        RT_NORMALS: upsample.downsample_nearest(res[NORMALS], rs),
                        RT_MOTION: upsample.downsample_nearest(res[MOTION_MR], rs)}

            graph.add_pass(
                "RT Downsample Pass",
                (Step(downsample_pass, dict.fromkeys((DEPTH, NORMALS, MOTION_MR), ROWS),
                      scale=rs),),
                inputs=(DEPTH, NORMALS, MOTION_MR), outputs=(RT_DEPTH, RT_NORMALS, RT_MOTION),
            )
        rt_depth, rt_normals, rt_motion = ((RT_DEPTH, RT_NORMALS, RT_MOTION) if rt_half
                                           else (DEPTH, NORMALS, MOTION_MR))

        if self._rt_needed():
            # grid-only RT shadows need no BVH: then the graph has no BVH pass
            use_grid = cfg.shadow_accel == "grid" and s.shadow_mode == ShadowMode.RAYTRACED
            bvh_needed = (s.ao_mode == AmbientOcclusionMode.RAYTRACED
                          or s.reflection_mode == ReflectionMode.RAYTRACED
                          or (s.shadow_mode == ShadowMode.RAYTRACED and not use_grid))
            rt_inputs = ["scene", "shade_tables", "TriRows", "pfd", rt_depth, rt_normals]
            if bvh_needed:
                add_bvh_pass(graph, cfg.animated)
                rt_inputs.append("BVH")
            if use_grid:
                # prebuilt on the host for static scenes (the renderer's
                # "shadow_grid"), rebuilt in-frame from this frame's world
                # triangles at the same resolution for animated ones
                if cfg.animated:
                    def grid_pass(res):
                        return {SHADOW_GRID: shadowgrid.build_shadow_grid(
                            res["WorldTris"], res["pfd"].directional_light.direction[:3],
                            grid=res["shadow_grid"].grid)}
                else:
                    def grid_pass(res):
                        return {SHADOW_GRID: res["shadow_grid"]}

                # the in-frame rebuild sizes the grid's tables from the
                # triangle count alone, as the load-time build does
                graph.add_pass("Shadow Grid Build", grid_pass,
                               inputs=("WorldTris", "pfd", "shadow_grid"),
                               outputs=(SHADOW_GRID,))
                rt_inputs.append(SHADOW_GRID)

            def raytrace_pass(res):
                shadow_ao, refl = raygen.raytrace_rows(
                    res["scene"], res["shade_tables"], res["TriRows"], res.get("BVH"),
                    res["pfd"], res[rt_depth], res[rt_normals], ao_rays=cfg.ao_rays,
                    settings=s, shadow_grid=res.get(SHADOW_GRID), rows=res["rows"],
                )
                return {RT_SHADOW_AO: shadow_ao, RT_REFLECTIONS: refl}

            graph.add_pass(
                "Raytrace Pass",
                (Step(raytrace_pass, {rt_depth: ROWS, rt_normals: ROWS}, scale=rs),),
                inputs=tuple(rt_inputs), outputs=(RT_SHADOW_AO, RT_REFLECTIONS),
            )

        if s.ao_mode == AmbientOcclusionMode.SSAO:
            def ssao_pass(res):
                return {SSAO_RAW: ssao.ssao(res["pfd"], res[DEPTH], res[NORMALS],
                                            radius=s.ssao.radius, rows=res["rows"])}

            def blur_pass(res):
                return {SSAO: ssao.ssao_blur(res[SSAO_RAW], rows=res["rows"])}

            # a sample's screen radius has no bound: the whole depth
            graph.add_pass("SSAO Pass", (Step(ssao_pass, {DEPTH: WHOLE, NORMALS: ROWS}),),
                           inputs=("pfd", DEPTH, NORMALS), outputs=(SSAO_RAW,))
            graph.add_pass("SSAO Blur Pass",
                           (Step(blur_pass, {SSAO_RAW: halo(ssao.BLUR_RADIUS)}),),
                           inputs=(SSAO_RAW,), outputs=(SSAO,))
            comp_sources["ssao_tex"] = SSAO

        if s.reflection_mode == ReflectionMode.SSR:
            def ssr_pass(res):
                return {SSR: ssr.ssr(res["pfd"], res[DEPTH], res[NORMALS], res[ALBEDO],
                                     res[MOTION_MR], s.ssr, rows=res["rows"])}

            # the march and the hit's shading read any row
            graph.add_pass("SSR Pass",
                           (Step(ssr_pass, dict.fromkeys((DEPTH, NORMALS, ALBEDO, MOTION_MR),
                                                         WHOLE)),),
                           inputs=("pfd", DEPTH, NORMALS, ALBEDO, MOTION_MR), outputs=(SSR,))
            comp_sources["ssr_tex"] = SSR

        shadow_ao_src, refl_src = RT_SHADOW_AO, RT_REFLECTIONS
        if self.uses_temporal_state:
            svgf_io = (rt_normals, rt_motion, RT_SHADOW_AO, "temporal_state")
            graph.add_pass(
                "SVGF Denoise Pass",
                svgf.denoise_steps(*svgf_io, DENOISED, "TemporalStateOut", scale=rs),
                inputs=svgf_io, outputs=(DENOISED, "TemporalStateOut"),
            )
            shadow_ao_src = DENOISED

        refl_rt = s.reflection_mode == ReflectionMode.RAYTRACED
        if rt_half:
            up_inputs = [shadow_ao_src, DEPTH, NORMALS, RT_DEPTH, RT_NORMALS]
            up_outputs = [UP_SHADOW_AO]
            if refl_rt:
                up_inputs.append(RT_REFLECTIONS)
                up_outputs.append(UP_REFLECTIONS)

            def rt_up_pass(res, src=shadow_ao_src):
                def up(lo):
                    return upsample.joint_bilateral_upsample(
                        lo, rs, res[DEPTH], res[NORMALS], res[RT_DEPTH], res[RT_NORMALS],
                        rows=res["rows"])

                out = {UP_SHADOW_AO: up(res[src])}
                if refl_rt:
                    out[UP_REFLECTIONS] = up(res[RT_REFLECTIONS])
                return out

            # the taps reach one low-resolution row past a slab's
            up_reads = {k: halo(1) for k in up_inputs}
            up_reads.update({DEPTH: ROWS, NORMALS: ROWS})
            graph.add_pass("RT Upsample Pass",
                           (Step(rt_up_pass, up_reads, scale=rs, out_scale=1),),
                           inputs=tuple(up_inputs), outputs=tuple(up_outputs))
            shadow_ao_src, refl_src = UP_SHADOW_AO, UP_REFLECTIONS

        if self._rt_needed():
            comp_sources["rt_shadow_ao"] = shadow_ao_src
            if refl_rt:
                comp_sources["rt_reflections"] = refl_src
        comp_inputs += comp_sources.values()

        def composition_pass(res):
            gb = GBuffer(albedo=res[ALBEDO], normal_oid=res[NORMALS],
                         motion_mr=res[MOTION_MR], depth=res[DEPTH])
            kwargs = {k: res[v] for k, v in comp_sources.items()}
            return {RENDER_OUTPUT: composition.compose(gb, res["pfd"], s, rows=res["rows"],
                                                       **kwargs)}

        # per pixel; the PCF reads the shadow map's replica
        graph.add_pass(
            "Composition Pass",
            (Step(composition_pass, {k: ROWS for k in comp_inputs[1:] if k != SHADOW_MAP}),),
            inputs=tuple(comp_inputs), outputs=(RENDER_OUTPUT,),
        )

