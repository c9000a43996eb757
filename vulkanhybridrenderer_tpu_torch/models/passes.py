"""Shared pass builders (port of ``models/passes.py``)."""
from __future__ import annotations

from vulkanhybridrenderer_tpu_torch.graph.render_graph import RenderGraph
from vulkanhybridrenderer_tpu_torch.ops import bvh, geometry, rasterizer_tiled, shadetab
from vulkanhybridrenderer_tpu_torch.utils.math3d import matmul4


def check_raster_supported(config) -> None:
    if config.raster != "binned":
        raise NotImplementedError(
            f"raster={config.raster!r}: the brute reference rasterizer is "
            "ROADMAP item 14; the port rasters binned"
        )
    rs = config.raster_state
    if rs.depth_compare != "greater_equal" or rs.depth_clear != 0.0:
        raise NotImplementedError(
            "depth-compare presets other than reverse-Z greater_equal: ROADMAP item 14"
        )


def rasterize_for_path(scene, clip, width, height, config, alpha: bool = True,
                       tables=None):
    """Binned raster honoring the cull mode.  With alpha and
    alpha_raster="brute" the alpha-masked triangles are depth-peeled with the
    fragment alpha kill (`config.alpha_peel_rounds` rounds, reading
    `tables`); otherwise they raster solid."""
    check_raster_supported(config)
    return rasterizer_tiled.rasterize_scene(
        scene, clip, width, height,
        cull_backface=config.raster_state.cull_mode == "back",
        alpha=alpha and config.alpha_raster != "off", tables=tables,
        alpha_rounds=config.alpha_peel_rounds,
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


def add_shadow_map_pass(graph: RenderGraph, size: int, config):
    """The depth-only prepass into the size x size shadow map from the
    light's view (forward_raster_render_path.cpp:13-41,
    hybrid_render_path.cpp:60-96): every triangle binned through K1a with
    the config's cull mode.  Its fragment shader is empty
    (depth_prepass.frag), so masked triangles raster solid."""

    def fn(res):
        vis = rasterize_for_path(res["scene"], res["LightClip"], size, size, config,
                                 alpha=False)
        return {"Shadow Map": vis.depth}

    graph.add_pass(
        "Depth Prepass", fn, inputs=("scene", "LightClip"), outputs=("Shadow Map",)
    )


def add_bvh_pass(graph: RenderGraph, animated: bool):
    """Static scenes reuse the BVH8 built at load (the reference builds its
    BLAS/TLAS once); per-frame refit is ROADMAP item 15."""
    if animated:
        raise NotImplementedError("animated scenes (BVH8 refit): ROADMAP item 15")
    graph.add_pass("BVH", lambda res: {"BVH": res["bvh"]}, inputs=("bvh",),
                   outputs=("BVH",))
