"""G-buffer resolve (port of ``ops/gbuffer.py``): visibility buffer -> G-buffer.

gbuf.frag:17-59 as one batched pass over the image: perspective-correct
attribute interpolation, base-color texturing, object-space normal mapping
(with the reference's unusual bitangent = cross(sampled_n, tangent) * w),
motion vectors from previous-frame reprojection, metallic / roughness (the
reference's G/B channel swap kept).  Clear values: albedo and normal+oid 0,
motion+mr (0, 0, -1, -1), depth 0.
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.core.types import GBuffer, PerFrameData
from vulkanhybridrenderer_tpu_torch.ops import shadetab
from vulkanhybridrenderer_tpu_torch.ops.rasterizer import VisibilityBuffer, weights_from_bary
from vulkanhybridrenderer_tpu_torch.utils.math3d import (
    cross,
    matmul4,
    normalize,
    transform_points,
)


def apply_normal_map(n_obj, tan_obj, nm_tex, ts_rgb):
    """Object-space normal mapping (gbuf.frag:35-41).  ts_rgb: the sampled
    normal-map texel rgb."""
    ts_n = normalize(ts_rgb * 2.0 - 1.0)
    bitangent = cross(ts_n, tan_obj[..., :3]) * tan_obj[..., 3:4]
    t_ortho = normalize(
        tan_obj[..., :3]
        - n_obj * torch.sum(tan_obj[..., :3] * n_obj, dim=-1, keepdim=True)
    )
    n_mapped = t_ortho * ts_n[..., 0:1] + bitangent * ts_n[..., 1:2] + n_obj * ts_n[..., 2:3]
    return torch.where((nm_tex >= 0)[..., None], n_mapped, n_obj)


def resolve_gbuffer(scene, tables, tri_rows, vis: VisibilityBuffer,
                    pfd: PerFrameData) -> GBuffer:
    """vis -> GBuffer (albedo, world normal + object id, motion + metallic /
    roughness, depth)."""
    h, w = vis.tri_id.shape
    dev = vis.depth.device
    valid = vis.tri_id >= 0
    tr = shadetab.fetch_tri(tri_rows, torch.clamp(vis.tri_id, min=0))

    wts = weights_from_bary(vis.bary)
    uv = shadetab.interpolate3(tr["uv0"], wts)
    n_obj = shadetab.interpolate3(tr["normal"], wts)
    tan_obj = shadetab.interpolate3(tr["tangent"], wts)
    pos_world = shadetab.interpolate3(tr["pos"], wts)

    albedo = shadetab.sample_atlas4(
        tables, tr["base_tex"], tr["base_scale"], tr["base_offset"], uv,
        fallback=tr["base_color"],
    )

    if scene.has_normal_maps:
        ts = shadetab.sample_atlas4(
            tables, tr["nm_tex"], tr["nm_scale"], tr["nm_offset"], uv
        )[..., :3]
        n_final_obj = apply_normal_map(n_obj, tan_obj, tr["nm_tex"], ts)
    else:
        n_final_obj = n_obj
    m = tr["normal_mat"]  # (H, W, 3, 3)
    n_world = normalize(
        m[..., 0] * n_final_obj[..., 0:1]
        + m[..., 1] * n_final_obj[..., 1:2]
        + m[..., 2] * n_final_obj[..., 2:3]
    )

    # motion vectors: current pixel uv - previous-frame uv of the surface
    xx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    yy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    cur_uv = torch.stack([xx[None, :].expand(h, w), yy[:, None].expand(h, w)], -1)
    prev_vp = matmul4(pfd.camera_proj_prev_frame, pfd.camera_view_prev_frame)
    prev_clip = transform_points(prev_vp, pos_world)
    prev_ndc = prev_clip[..., :2] / prev_clip[..., 3:4]
    motion = cur_uv - (prev_ndc * 0.5 + 0.5)

    if scene.has_mr_textures:
        mr = shadetab.sample_atlas4(
            tables, tr["mr_tex"], tr["mr_scale"], tr["mr_offset"], uv
        )
        has_mr = tr["mr_tex"] >= 0
        metallic = tr["metallic"] * torch.where(has_mr, mr[..., 1], 1.0)
        roughness = tr["roughness"] * torch.where(has_mr, mr[..., 2], 1.0)
    else:
        metallic = tr["metallic"]
        roughness = tr["roughness"]

    vf = valid[..., None]
    albedo_out = torch.where(vf, albedo, 0.0)
    normal_oid = torch.where(
        vf, torch.cat([n_world, tr["prim"][..., None].to(torch.float32)], -1), 0.0
    )
    mr_clear = torch.tensor([0.0, 0.0, -1.0, -1.0], device=dev)
    motion_mr = torch.where(
        vf, torch.cat([motion, metallic[..., None], roughness[..., None]], -1),
        mr_clear,
    )
    return GBuffer(
        albedo=albedo_out.permute(2, 0, 1).contiguous(),
        normal_oid=normal_oid.permute(2, 0, 1).contiguous(),
        motion_mr=motion_mr.permute(2, 0, 1).contiguous(),
        depth=vis.depth,
    )
