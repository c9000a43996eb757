"""Shared pass builders (port of ``models/passes.py``)."""
from __future__ import annotations

from vulkanhybridrenderer_tpu_torch.graph.render_graph import RenderGraph
from vulkanhybridrenderer_tpu_torch.ops import geometry, rasterizer_tiled, shadetab
from vulkanhybridrenderer_tpu_torch.utils.math3d import matmul4


def check_raster_supported(config) -> None:
    if config.raster != "binned":
        raise NotImplementedError(
            f"raster={config.raster!r}: the brute reference rasterizer is "
            "ROADMAP item 14; the port rasters binned"
        )
    if config.alpha_raster != "off":
        raise NotImplementedError(
            f"alpha_raster={config.alpha_raster!r}: the binned alpha depth-peel "
            "is ROADMAP item 10; use alpha_raster='off'"
        )
    rs = config.raster_state
    if rs.depth_compare != "greater_equal" or rs.depth_clear != 0.0:
        raise NotImplementedError(
            "depth-compare presets other than reverse-Z greater_equal: ROADMAP item 14"
        )


def rasterize_for_path(scene, clip, width, height, config):
    """Binned opaque raster (K1a) honoring the cull mode; alpha-masked
    geometry rasters solid."""
    check_raster_supported(config)
    return rasterizer_tiled.rasterize_scene(
        scene, clip, width, height,
        cull_backface=config.raster_state.cull_mode == "back",
    )


def add_geometry_pass(graph: RenderGraph):
    """Vertex transforms: object -> world -> camera clip space, and this
    frame's TriRow table.  (The reference also emits the light-space clip
    and world triangles for the shadow map, the BVH refit and reflection
    shading; they come back with those passes.)"""

    def fn(res):
        scene = res["scene"]
        pfd = res["pfd"]
        world = geometry.to_world(scene, res.get("prim_transform"))
        clip = geometry.to_clip(world.position, matmul4(pfd.camera_proj, pfd.camera_view))
        tri_rows = shadetab.make_tri_rows(res["shade_tables"], scene, world.position, clip)
        return {"Clip": clip, "TriRows": tri_rows}

    graph.add_pass(
        "Geometry", fn,
        inputs=("scene", "pfd", "prim_transform", "shade_tables"),
        outputs=("Clip", "TriRows"),
    )


def add_bvh_pass(graph: RenderGraph, animated: bool):
    """Static scenes reuse the BVH8 built at load (the reference builds its
    BLAS/TLAS once); per-frame refit is ROADMAP item 15."""
    if animated:
        raise NotImplementedError("animated scenes (BVH8 refit): ROADMAP item 15")
    graph.add_pass("BVH", lambda res: {"BVH": res["bvh"]}, inputs=("bvh",),
                   outputs=("BVH",))
