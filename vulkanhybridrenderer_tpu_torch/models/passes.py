"""Shared pass builders (port of ``models/passes.py``)."""
from __future__ import annotations

import warnings

from vulkanhybridrenderer_tpu_torch.graph.render_graph import ROWS, RenderGraph, Step
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
from vulkanhybridrenderer_tpu_torch.ops.rasterizer import VisibilityBuffer
from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh
from vulkanhybridrenderer_tpu_torch.utils.math3d import matmul4


def rasterize_for_path(scene, clip, width, height, config, alpha: bool = True,
                       mesh=None, tables=None):
    """The raster of `config.raster`, honoring `config.raster_state`.
    "binned": the tile raster (K1), which implements the reverse-Z
    greater_equal preset; with alpha and alpha_raster="brute" the
    alpha-masked triangles are depth-peeled with the fragment alpha kill
    (`config.alpha_peel_rounds` rounds, reading `tables`).  With a `mesh`
    whose shard count divides `height`, the binned raster runs
    triangle-sharded with a sort-last composite
    (parallel/mesh.rasterize_scene_sharded, whose peel runs 4 rounds, as
    the reference's); where it does not, the single-device raster, with a
    warning.  "brute": the reference rasterizer with any
    depth-compare preset and the exact per-fragment alpha kill.  With
    alpha_raster="off" masked triangles raster solid."""
    alpha = alpha and config.alpha_raster != "off"
    rs = config.raster_state
    cull = rs.cull_mode == "back"
    if config.raster == "binned":
        _check_binned_preset(config)
        if mesh is not None and height % mesh.devices.size == 0:
            return pmesh.rasterize_scene_sharded(scene, clip, width, height, mesh,
                                                 alpha=alpha, cull_backface=cull,
                                                 tables=tables)
        if mesh is not None:
            warnings.warn(f"rasterize_for_path: {height} rows do not divide over the mesh's "
                          f"{mesh.devices.size} shards; the raster runs on {mesh.primary} "
                          "alone, as the reference's mesh does")
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


def _check_binned_preset(config):
    rs = config.raster_state
    if rs.depth_compare != "greater_equal" or rs.depth_clear != 0.0:
        raise NotImplementedError(
            "the binned kernel implements the reverse-Z greater_equal "
            "preset; use config.raster='brute' for other depth states"
        )


def rasterize_bands(scene, clip, width, height, config, alpha: bool = True, mesh=None,
                    tables=None):
    """rasterize_for_path for a pass that keeps the frame row-sharded over
    `mesh`: where the binned raster runs sort-last, its bands
    (parallel/mesh.rasterize_scene_bands: a list of VisibilityBuffers, band
    j on the mesh's device j), not gathered; elsewhere (and without a mesh)
    rasterize_for_path's VisibilityBuffer.  `height` is the raster's own
    (the forward path's supersample rasters ss times the frame's rows)."""
    if mesh is None or config.raster != "binned" or height % mesh.devices.size:
        return rasterize_for_path(scene, clip, width, height, config, alpha, mesh, tables)
    _check_binned_preset(config)
    return pmesh.rasterize_scene_bands(scene, clip, width, height, mesh,
                                       alpha=alpha and config.alpha_raster != "off",
                                       cull_backface=config.raster_state.cull_mode == "back",
                                       tables=tables)


#: the raster step's visibility (raster_steps), the barycentrics
#: channel-planar, (3, H, W), so that rows are dim -2
_VIS = ("Raster Tri ID", "Raster Visible Depth", "Raster Barycentrics")


def raster_steps(width, height, config, then, alpha: bool = True) -> tuple[Step, Step]:
    """A pass's raster and what follows it, as two Steps.  The raster
    (reads None: it splits its own work over a mesh) is rasterize_bands of
    res's scene and "Clip" at width x height: over a mesh the sort-last
    composite's bands, kept as Slabs, else (or where it does not run) the
    whole raster.  Then `then(res, vis)` returns the pass's outputs from
    the VisibilityBuffer `vis`: over a mesh on each shard over its band;
    where graph.run runs the steps on one device with a mesh in res, over
    the bands gathered."""

    def raster(res):
        vis = rasterize_bands(res["scene"], res["Clip"], width, height, config, alpha,
                              mesh=res.get("mesh"), tables=res["shade_tables"])
        bands = [(v.tri_id, v.depth, v.bary.permute(2, 0, 1))
                 for v in (vis if isinstance(vis, list) else [vis])]
        if isinstance(vis, list):
            return {k: pmesh.Slabs(parts) for k, parts in zip(_VIS, zip(*bands))}
        return dict(zip(_VIS, bands[0]))

    def after(res):
        mesh = res.get("mesh")
        tri, depth, bary = (res[k] if mesh is None else mesh.whole(res[k], "raster")
                            for k in _VIS)
        return then(res, VisibilityBuffer(tri_id=tri, depth=depth, bary=bary.permute(1, 2, 0)))

    return Step(raster, None), Step(after, dict.fromkeys(_VIS, ROWS))


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
    reverse-Z preset (the reference's render_shadow_map).  The binned
    prepass runs over the frame's mesh (``res["mesh"]``) when there is one."""

    def fn(res):
        if config is not None and config.raster == "binned":
            vis = rasterize_for_path(res["scene"], res["LightClip"], size, size, config,
                                     alpha=False, mesh=res.get("mesh"))
            return {"Shadow Map": vis.depth}
        return {"Shadow Map": shadowmap.render_shadow_map(
            res["LightClip"], res["scene"].tri_vertex, size, chunk=chunk)}

    graph.add_pass("Depth Prepass", fn, inputs=("scene", "LightClip"), outputs=("Shadow Map",))


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
