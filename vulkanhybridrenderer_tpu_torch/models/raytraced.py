"""Full ray-traced render path (reference raytraced_render_path.cpp:11-76;
port of ``models/raytraced.py``).

Passes: Geometry -> BVH -> Raytrace Pass (primary rays, closest-hit shading,
one shadow ray per hit) -> Composition (the blit to RENDER_OUTPUT).

Primary rays are raygen.rgen:11-20: origin = view_inverse @ (0, 0, 0, 1),
direction = view_inverse @ normalize(proj_inverse @ (ndc.xy, 1, 1)).xyz,
tmin 0.1, tmax 10000, traced closest-hit through K2.  Shadow rays go from
the hit position toward the light, tmin 0.1, any-hit.  A miss is the sky
(0.3, 0.8, 0.2, 1) (miss.rmiss:7).

``RaytracedSettings.test_alpha`` is the any-hit variant pipeline
(raygen_test_alpha / closesthit_test_alpha / shadow_anyhit): both wavefronts
go through K2's alpha any-hit filter when the scene has masked materials,
and the hit shader takes its other constants.  The reference's tilers,
strips and packets have no counterpart: one GPU thread traces one ray.

Both passes are registered as Steps (graph/render_graph.py): on one device
they run over every row; over a device mesh (parallel/mesh.py) each shard
makes, traces and shades its row slab's rays, and the blit copies its slab,
as the reference's GSPMD partitions the row-sharded frame.
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.graph.render_graph import (
    RENDER_OUTPUT,
    ROWS,
    RenderGraph,
    Step,
)
from vulkanhybridrenderer_tpu_torch.models.base import RenderPath
from vulkanhybridrenderer_tpu_torch.models.passes import add_bvh_pass, add_geometry_pass
from vulkanhybridrenderer_tpu_torch.ops import rt_shade, screen, traverse
from vulkanhybridrenderer_tpu_torch.utils.consts import device_constant
from vulkanhybridrenderer_tpu_torch.utils.math3d import (
    normalize,
    transform_directions,
    transform_points,
)

SKY = (0.3, 0.8, 0.2, 1.0)  # miss.rmiss:7
PRIMARY_TMIN = 0.1
SHADOW_TMIN = 0.1
TMAX = 10000.0
OUTPUT = "Raytraced Output"


def primary_rays(pfd, height: int, width: int, rows: screen.Rows | None = None):
    """raygen.rgen:11-18: origins and directions, (R, 3) each, in image
    order: every pixel's, or those of `rows` (a screen.Rows of the image),
    equal to those rows of the whole image's."""
    r0, n = (0, None) if rows is None else (rows.start, rows.count)
    uv = screen.pixel_uv_grid(height, width, device=pfd.camera_view.device, row0=r0,
                              rows=n).reshape(-1, 2)
    ndc = uv * 2.0 - 1.0
    target = transform_points(pfd.camera_proj_inverse,
                              torch.cat([ndc, torch.ones_like(ndc[:, :1])], dim=-1))
    d_world = transform_directions(pfd.camera_view_inverse, normalize(target[:, :3]))
    origin = pfd.camera_view_inverse[:3, 3].expand(d_world.shape)
    return origin.contiguous(), d_world.contiguous()


class RaytracedPath(RenderPath):
    name = "raytraced"

    def register(self, graph: RenderGraph) -> None:
        cfg = self.config
        h, w = cfg.height, cfg.width
        test_alpha = cfg.raytraced.test_alpha

        add_geometry_pass(graph)
        add_bvh_pass(graph, cfg.animated)

        def raytrace_step(res):
            scene, pfd, bvh, tables = res["scene"], res["pfd"], res["BVH"], res["shade_tables"]
            rows = res["rows"]
            # the filter changes nothing on a scene without masked materials
            alpha = tables if test_alpha and scene.has_alpha_mask else None
            o, d = primary_rays(pfd, h, w, rows)
            rec = traverse.trace(bvh, None, o, d, PRIMARY_TMIN, TMAX, alpha_tables=alpha)
            pos = rt_shade.interpolate_hit_attributes(
                tables, res["TriRows"], rec.tri, rec.u, rec.v)["position"]
            # a missed primary ray shows the sky: its shadow ray is dead
            sh_tmax = torch.where(rec.hit, TMAX, -1.0)
            sh_dir = (-pfd.directional_light.direction[:3]).expand(pos.shape).contiguous()
            shadow = traverse.trace(bvh, None, pos.contiguous(), sh_dir, SHADOW_TMIN, sh_tmax,
                                    anyhit=True, alpha_tables=alpha)
            shaded = rt_shade.primary_hit_shade(
                scene, tables, res["TriRows"], pfd, rec.tri, rec.u, rec.v, ~shadow.hit,
                test_alpha=test_alpha,
            )
            sky = device_constant(SKY, device=shaded.device)
            img = torch.where(rec.hit[:, None], shaded, sky)
            n = h if rows is None else rows.count
            return {OUTPUT: img.reshape(n, w, 4).permute(2, 0, 1).contiguous()}

        # every pixel's rays are made, traced and shaded where its row lies:
        # over a mesh each shard its slab, on its replicas of the scene,
        # the BVH8 and the tables
        graph.add_pass(
            "Raytrace Pass", (Step(raytrace_step, {}),),
            inputs=("scene", "pfd", "BVH", "shade_tables", "TriRows"), outputs=(OUTPUT,),
        )
        graph.add_pass("Composition", (Step(lambda res: {RENDER_OUTPUT: res[OUTPUT]},
                                            {OUTPUT: ROWS}),),
                       inputs=(OUTPUT,), outputs=(RENDER_OUTPUT,))
