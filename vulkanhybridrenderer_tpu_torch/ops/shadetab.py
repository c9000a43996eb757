"""Fused shading tables (port of ``ops/shadetab.py``).

The per-pixel resolve reads everything it needs about a triangle from one
row of the TriRow table (T, 72): three world positions and clip w (rebuilt
per frame), object-space normals, tangents, uv0, and the owning primitive's
material row folded in.  Bilinear texture taps read one row of the
quad-packed atlas (AH*AW, 16): a texel and its +x, +y, +xy neighbors, wrap-
correct thanks to the atlas packer's 1-texel border.  The layout was shaped
for TPU gathers; the port keeps it because it is simple and the sampled
values are then identical to the reference's by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

# TriRow column map
_POS = 0  # [0:9)   v0.xyz v1.xyz v2.xyz world position (per frame)
_CLIPW = 9  # [9:12)  clip-space w per vertex (per frame)
_NRM = 12  # [12:21) object-space normals
_TAN = 21  # [21:33) tangents xyzw
_UV0 = 33  # [33:39) uv0
_PRIM = 39  # [39]    primitive id
_PMAT = 40  # [40:72) the owning primitive's PrimRow
TRI_ROW_W = 72
_N_STATIC = TRI_ROW_W - _NRM

# PrimRow column map
_BASE_COL = 0  # [0:4) base color factor
_BASE_TEX = 4  # [4] texture id, [5:7) uv scale, [7:9) uv offset
_NM_TEX = 9
_MR_TEX = 14
_METAL = 19
_ROUGH = 20
_AMASK = 21
_ACUT = 22
_NMAT = 23  # [23:32) 3x3 normal matrix, row-major
PRIM_ROW_W = 32


@dataclasses.dataclass(frozen=True)
class ShadeTables:
    tri_static: Any  # (T, 60) static TriRow columns [12:72)
    prim_rows: Any  # (P, 32)
    atlas_q: Any  # (AH*AW, 16) quad-packed texel-major atlas
    atlas_w: int = 1


def _tex_scale_offset(atlas, tex_ids):
    safe = torch.clamp(tex_ids, min=0).long()
    return atlas.uv_scale[safe], atlas.uv_offset[safe]


def build_shade_tables(scene) -> ShadeTables:
    """Pack the static tables once per scene (scene on its device)."""
    tv = scene.tri_vertex.long()
    cols = []
    for j in range(3):
        cols.append(scene.normals[tv[:, j]])
    for j in range(3):
        cols.append(scene.tangents[tv[:, j]])
    for j in range(3):
        cols.append(scene.uv0[tv[:, j]])
    cols.append(scene.tri_prim.to(torch.float32)[:, None])

    m = scene.materials
    atlas = scene.atlas
    bs, bo = _tex_scale_offset(atlas, m.base_color_texture)
    ns, no = _tex_scale_offset(atlas, m.normal_map)
    ms, mo = _tex_scale_offset(atlas, m.metallic_roughness_texture)
    nmat = scene.prim_normal_mat.reshape(-1, 16)[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]]
    f = lambda a: a.to(torch.float32)[:, None]  # noqa: E731
    prim_rows = torch.cat(
        [
            m.base_color, f(m.base_color_texture), bs, bo,
            f(m.normal_map), ns, no,
            f(m.metallic_roughness_texture), ms, mo,
            f(m.metallic_factor), f(m.roughness_factor), f(m.alpha_mask),
            f(m.alpha_cutoff), nmat,
        ],
        dim=-1,
    )
    assert prim_rows.shape[1] == PRIM_ROW_W
    tri_static = torch.cat(cols + [prim_rows[scene.tri_prim.long()]], dim=-1)
    assert tri_static.shape[1] == _N_STATIC

    base = scene.atlas.data.to(torch.float32).permute(1, 2, 0)  # (AH, AW, 4)
    ah, aw, _ = base.shape
    # +1 in atlas space IS the REPEAT neighbor of every interior texel (the
    # packer's wrap border), so whole-atlas rolls build the quad rows
    right = torch.roll(base, -1, dims=1)
    down = torch.roll(base, -1, dims=0)
    diag = torch.roll(right, -1, dims=0)
    atlas_q = torch.cat([base, right, down, diag], dim=-1).reshape(ah * aw, 16)
    return ShadeTables(
        tri_static=tri_static.contiguous(), prim_rows=prim_rows,
        atlas_q=atlas_q.contiguous(), atlas_w=aw,
    )


def make_tri_rows(tables: ShadeTables, scene, world_pos, clip):
    """Per-frame TriRows: world positions and clip w per vertex, next to the
    static block."""
    tv = scene.tri_vertex.long()
    t = tv.shape[0]
    posw = torch.cat([world_pos, clip[:, 3:4]], dim=-1)  # (V, 4)
    rows = posw[tv.reshape(-1)].reshape(t, 3, 4)
    dyn = torch.cat([rows[..., :3].reshape(t, 9), rows[..., 3]], dim=-1)
    return torch.cat([dyn, tables.tri_static], dim=-1)  # (T, 72)


def _prim_fields(row, base):
    s = row.shape[:-1]
    return dict(
        base_color=row[..., base + _BASE_COL:base + _BASE_COL + 4],
        base_tex=row[..., base + _BASE_TEX].to(torch.int32),
        base_scale=row[..., base + _BASE_TEX + 1:base + _BASE_TEX + 3],
        base_offset=row[..., base + _BASE_TEX + 3:base + _BASE_TEX + 5],
        nm_tex=row[..., base + _NM_TEX].to(torch.int32),
        nm_scale=row[..., base + _NM_TEX + 1:base + _NM_TEX + 3],
        nm_offset=row[..., base + _NM_TEX + 3:base + _NM_TEX + 5],
        mr_tex=row[..., base + _MR_TEX].to(torch.int32),
        mr_scale=row[..., base + _MR_TEX + 1:base + _MR_TEX + 3],
        mr_offset=row[..., base + _MR_TEX + 3:base + _MR_TEX + 5],
        metallic=row[..., base + _METAL],
        roughness=row[..., base + _ROUGH],
        alpha_mask=row[..., base + _AMASK],
        alpha_cutoff=row[..., base + _ACUT],
        normal_mat=row[..., base + _NMAT:base + _NMAT + 9].reshape(*s, 3, 3),
    )


def fetch_tri(tri_rows, tri_ids):
    """One row gather -> per-pixel vertex attributes ((..., 3, k), vertex-
    major) and the owning primitive's material fields."""
    row = tri_rows[tri_ids.long()]
    s = tri_ids.shape
    out = dict(
        pos=row[..., _POS:_POS + 9].reshape(*s, 3, 3),
        clip_w=row[..., _CLIPW:_CLIPW + 3],
        normal=row[..., _NRM:_NRM + 9].reshape(*s, 3, 3),
        tangent=row[..., _TAN:_TAN + 12].reshape(*s, 3, 4),
        uv0=row[..., _UV0:_UV0 + 6].reshape(*s, 3, 2),
        prim=row[..., _PRIM].to(torch.int32),
    )
    out.update(_prim_fields(row, _PMAT))
    return out


def fetch_prim(prim_rows, prim_ids):
    """One PrimRow gather -> the material and primitive fields per id, for
    consumers holding a primitive id without a TriRow."""
    return _prim_fields(prim_rows[prim_ids.long()], 0)


def fetch_tri_static(tables: ShadeTables, tri_ids):
    """One static-row gather -> per-vertex uv0 ((..., 3, 2)) and the owning
    primitive's material fields, for consumers without the per-frame
    TriRows (the fragment alpha kill)."""
    row = tables.tri_static[tri_ids.long()]
    s = tri_ids.shape
    off = _UV0 - _NRM
    out = dict(uv0=row[..., off:off + 6].reshape(*s, 3, 2))
    out.update(_prim_fields(row, _PMAT - _NRM))
    return out


def fetch_alpha_fields(tables: ShadeTables, tri_ids):
    """fetch_tri_static's fields that the fragment alpha kill reads (uv0,
    the base texture's id, scale and offset, the alpha mask and cutoff),
    from a gather of those 13 columns of each row instead of all 60."""
    st = tables.tri_static
    uv, tex, amask = _UV0 - _NRM, _PMAT - _NRM + _BASE_TEX, _PMAT - _NRM + _AMASK
    row = torch.cat([st[:, uv:uv + 6], st[:, tex:tex + 5], st[:, amask:amask + 2]],
                    dim=1)[tri_ids.long()]
    s = tri_ids.shape
    return dict(uv0=row[..., 0:6].reshape(*s, 3, 2), base_tex=row[..., 6].to(torch.int32),
                base_scale=row[..., 7:9], base_offset=row[..., 9:11],
                alpha_mask=row[..., 11], alpha_cutoff=row[..., 12])


def fetch_tri_uv(tables: ShadeTables, tri_ids):
    """One static-row gather -> per-vertex uv0 (..., 3, 2)."""
    return fetch_tri_static(tables, tri_ids)["uv0"]


def interpolate3(attr, weights):
    """attr (..., 3, k) per-vertex values + (..., 3) weights -> (..., k)."""
    w = weights[..., None]
    return (attr[..., 0, :] * w[..., 0, :] + attr[..., 1, :] * w[..., 1, :]) + (
        attr[..., 2, :] * w[..., 2, :]
    )


def _atlas_tap(tables: ShadeTables, scale, offset, uv):
    """A bilinear tap's quad row (REPEAT wrap, half-texel centers) and its
    (..., 1) x and y weights."""
    aw = tables.atlas_w
    u = uv - torch.floor(uv)
    t = u * scale - 0.5
    t0 = torch.floor(t)
    f = t - t0
    x0 = torch.remainder(t0[..., 0], torch.clamp(scale[..., 0], min=1.0))
    y0 = torch.remainder(t0[..., 1], torch.clamp(scale[..., 1], min=1.0))
    lin = (offset[..., 1] + y0).to(torch.int64) * aw + (offset[..., 0] + x0).to(
        torch.int64
    )
    # out-of-range addresses clamp, like the reference's XLA gather
    return torch.clamp(lin, 0, tables.atlas_q.shape[0] - 1), f[..., 0:1], f[..., 1:2]


def _blend(c00, c10, c01, c11, fx, fy):
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def sample_atlas_alpha(tables: ShadeTables, tex_id, scale, offset, uv):
    """sample_atlas4(...)[..., 3] with the same operations on the alpha
    channel alone, from a gather of 4 floats a tap instead of 16."""
    lin, fx, fy = _atlas_tap(tables, scale, offset, uv)
    q = tables.atlas_q[:, 3::4][lin]
    out = _blend(q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4], fx, fy)[..., 0]
    return torch.where(tex_id >= 0, out, 1.0)


def sample_atlas4(tables: ShadeTables, tex_id, scale, offset, uv, fallback=None):
    """Bilinear atlas sample (REPEAT wrap, half-texel centers) from one quad
    row; tex_id < 0 -> fallback (default 1)."""
    lin, fx, fy = _atlas_tap(tables, scale, offset, uv)
    q = tables.atlas_q[lin]
    c00, c10, c01, c11 = q[..., 0:4], q[..., 4:8], q[..., 8:12], q[..., 12:16]
    out = _blend(c00, c10, c01, c11, fx, fy)
    if fallback is None:
        fallback = torch.ones(4, dtype=torch.float32, device=uv.device)
    return torch.where((tex_id >= 0)[..., None], out, fallback)
