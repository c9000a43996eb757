"""Shared pass builders (port of ``models/passes.py``)."""
from __future__ import annotations

from vulkanhybridrenderer_tpu_torch.graph.render_graph import RenderGraph
from vulkanhybridrenderer_tpu_torch.ops import (
    bvh,
    bvh8,
    gbuffer,
    geometry,
    rasterizer,
    rasterizer_tiled,
    shadetab,
    shadowmap,
)
from vulkanhybridrenderer_tpu_torch.utils.math3d import matmul4


def rasterize_for_path(scene, clip, width, height, config, alpha: bool = True,
                       tables=None):
    """The raster of `config.raster`, honoring `config.raster_state`.
    "binned": the tile raster (K1), which implements the reverse-Z
    greater_equal preset; with alpha and alpha_raster="brute" the
    alpha-masked triangles are depth-peeled with the fragment alpha kill
    (`config.alpha_peel_rounds` rounds, reading `tables`).  "brute": the
    reference rasterizer with any depth-compare preset and the exact
    per-fragment alpha kill.  With alpha_raster="off" masked triangles
    raster solid."""
    alpha = alpha and config.alpha_raster != "off"
    rs = config.raster_state
    cull = rs.cull_mode == "back"
    if config.raster == "binned":
        if rs.depth_compare != "greater_equal" or rs.depth_clear != 0.0:
            raise NotImplementedError(
                "the binned kernel implements the reverse-Z greater_equal "
                "preset; use config.raster='brute' for other depth states"
            )
        return rasterizer_tiled.rasterize_scene(
            scene, clip, width, height, cull_backface=cull, alpha=alpha, tables=tables,
            alpha_rounds=config.alpha_peel_rounds,
        )
    setup = rasterizer.triangle_setup(clip, scene.tri_vertex, width, height)
    mask_fn = (gbuffer.make_alpha_frag_mask(scene, clip, tables=tables)
               if alpha and scene.has_alpha_mask else None)
    return rasterizer.rasterize(
        setup, width, height, frag_mask_fn=mask_fn, cull_backface=cull,
        depth_compare=rs.depth_compare, depth_clear=rs.depth_clear,
    )


def add_geometry_pass(graph: RenderGraph):
    """Vertex transforms: object -> world -> camera and light clip space, the
    world triangles (what a BVH refit reads) and this frame's TriRow table:
    the reference's outputs, so both list the same resources."""

    def fn(res):
        scene = res["scene"]
        pfd = res["pfd"]
        world = geometry.to_world(scene, res.get("prim_transform"))
        clip = geometry.to_clip(world.position, matmul4(pfd.camera_proj, pfd.camera_view))
        light_clip = geometry.to_clip(world.position, pfd.directional_light.projview)
        tris = bvh.world_triangles(world.position, scene.tri_vertex)
        tri_rows = shadetab.make_tri_rows(res["shade_tables"], scene, world.position, clip)
        return {"World": world, "Clip": clip, "LightClip": light_clip, "WorldTris": tris,
                "TriRows": tri_rows}

    graph.add_pass(
        "Geometry", fn,
        inputs=("scene", "pfd", "prim_transform", "shade_tables"),
        outputs=("World", "Clip", "LightClip", "WorldTris", "TriRows"),
    )


def add_shadow_map_pass(graph: RenderGraph, size: int, config=None, chunk: int = 256):
    """The depth-only prepass into the size x size shadow map from the
    light's view (forward_raster_render_path.cpp:13-41,
    hybrid_render_path.cpp:60-96).  Its fragment shader is empty
    (depth_prepass.frag), so masked triangles raster solid.  A config whose
    raster is "binned": every triangle through K1a with the config's cull
    mode; "brute" or no config (as in the reference): the reference
    rasterizer in chunks of `chunk` triangles, back faces culled, the
    reverse-Z preset (the reference's render_shadow_map)."""

    def fn(res):
        if config is not None and config.raster == "binned":
            vis = rasterize_for_path(res["scene"], res["LightClip"], size, size, config,
                                     alpha=False)
            return {"Shadow Map": vis.depth}
        return {"Shadow Map": shadowmap.render_shadow_map(
            res["LightClip"], res["scene"].tri_vertex, size, chunk=chunk)}

    graph.add_pass(
        "Depth Prepass", fn, inputs=("scene", "LightClip"), outputs=("Shadow Map",)
    )


def add_bvh_pass(graph: RenderGraph, animated: bool):
    """The acceleration structure.  Static scenes reuse the BVH8 built at
    load (the reference builds its BLAS / TLAS once); animated scenes refit
    it every frame from this frame's world triangles ("BVH Refit", the
    analogue of UpdateBLAS on a geometry update)."""
    if animated:
        graph.add_pass("BVH Refit", lambda res: {"BVH": bvh8.refit8(res["bvh"], res["WorldTris"])},
                       inputs=("bvh", "WorldTris"), outputs=("BVH",))
    else:
        graph.add_pass("BVH", lambda res: {"BVH": res["bvh"]}, inputs=("bvh",),
                       outputs=("BVH",))
