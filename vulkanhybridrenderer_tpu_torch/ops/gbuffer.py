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
from vulkanhybridrenderer_tpu_torch.ops import screen, shadetab
from vulkanhybridrenderer_tpu_torch.ops.rasterizer import VisibilityBuffer, weights_from_bary
from vulkanhybridrenderer_tpu_torch.utils.consts import device_constant
from vulkanhybridrenderer_tpu_torch.utils.math3d import (
    cross,
    matmul4,
    normalize,
    transform_points,
)


def perspective_weights(bary2, inv_w3):
    """Screen barycentrics (..., 2) and per-vertex 1/w (..., 3) ->
    perspective-correct weights (..., 3)."""
    l1, l2 = bary2[..., 0], bary2[..., 1]
    pw = torch.stack([1.0 - l1 - l2, l1, l2], dim=-1) * inv_w3
    return pw / torch.sum(pw, dim=-1, keepdim=True)


def interpolate(attr_v, vidx, weights):
    """attr_v (V, K) vertex attribute, vidx (..., 3) vertex ids, weights
    (..., 3) -> (..., K), the three terms summed in vertex order.  A
    reference-path helper: the resolve interpolates from the TriRow tables
    (ops/shadetab.py)."""
    out = None
    for j in range(3):
        term = attr_v[vidx[..., j].long()] * weights[..., j:j + 1]
        out = term if out is None else out + term
    return out


def make_alpha_frag_mask(scene, clip=None, tables=None):
    """The per-fragment alpha kill of the brute rasterizer (gbuf.frag:27-32,
    the reference's make_alpha_frag_mask): a fragment of an alpha-masked,
    textured material whose base-color alpha is below the cutoff is
    discarded during the depth test.  Returns frag_mask(tri_ids (C,),
    wts (C, H, W, 3)) -> keep (C, H, W), as the reference's, where `wts` are
    perspective-correct vertex weights; a triangle's fields come from one
    gather of the 13 static-row columns the test reads, and each fragment
    takes one alpha tap of the atlas (shadetab.fetch_alpha_fields,
    sample_atlas_alpha: equal to the full row's and quad's).  `clip` is
    unused (the reference's signature); `tables=None` builds the shade
    tables here."""
    if tables is None:
        tables = shadetab.build_shade_tables(scene)

    def frag_mask(tri_ids, wts):
        pm = shadetab.fetch_alpha_fields(tables, tri_ids)
        needs_test = (pm["alpha_mask"] == 1.0) & (pm["base_tex"] >= 0)
        uv = shadetab.interpolate3(pm["uv0"][:, None, None], wts)
        alpha = shadetab.sample_atlas_alpha(
            tables, pm["base_tex"][:, None, None], pm["base_scale"][:, None, None],
            pm["base_offset"][:, None, None], uv)
        return ~(needs_test[:, None, None] & (alpha < pm["alpha_cutoff"][:, None, None]))

    return frag_mask


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
                    pfd: PerFrameData, rows: screen.Rows | None = None) -> GBuffer:
    """vis -> GBuffer (albedo, world normal + object id, motion + metallic /
    roughness, depth).  Per pixel: `vis` may be the `rows` of a taller
    image (a mesh shard's band), whose motion vectors then use those rows'
    screen coordinates."""
    h, w = vis.tri_id.shape
    rows = rows or screen.Rows.whole(h)
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
    cur_uv = screen.pixel_uv_grid(rows.height, w, dev, rows.start, h)
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
    mr_clear = device_constant([0.0, 0.0, -1.0, -1.0], device=dev)
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
