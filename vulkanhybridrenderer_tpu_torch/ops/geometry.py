"""Vertex transforms (port of ``ops/geometry.py``): object -> world -> clip for
the whole scene in one batched pass per frame (gbuf.vert:21-28)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from vulkanhybridrenderer_tpu_torch.core.types import SceneBuffers
from vulkanhybridrenderer_tpu_torch.utils.math3d import normalize


@dataclasses.dataclass(frozen=True)
class WorldGeometry:
    position: Any  # (V, 3)
    normal: Any  # (V, 3) normal-matrix transformed
    tangent: Any  # (V, 4) xyz + handedness w
    vertex_prim: Any  # (V,) int64 owning primitive


def vertex_prim_ids(scene: SceneBuffers):
    """(V,) primitive id per vertex (vertex ranges per primitive are
    contiguous and ascending)."""
    vid = torch.arange(
        scene.num_vertices, dtype=torch.int32, device=scene.positions.device
    )
    return torch.searchsorted(scene.prim_vertex_offset, vid, right=True) - 1


def _apply(m, p, translate: bool):
    """Rows 0..2 of per-vertex (V, 4, 4) matrices applied to (V, 3) vectors,
    summed in the reference's order."""
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    out = m[:, :3, 0] * x + m[:, :3, 1] * y + m[:, :3, 2] * z
    return out + m[:, :3, 3] if translate else out


def to_world(scene: SceneBuffers, prim_transform=None, prim_normal_mat=None) -> WorldGeometry:
    """Object -> world for all vertices.  prim_transform and prim_normal_mat
    override the scene's primitive matrices and normal matrices (animation)."""
    m = scene.prim_transform if prim_transform is None else prim_transform
    nm = scene.prim_normal_mat if prim_normal_mat is None else prim_normal_mat
    vprim = vertex_prim_ids(scene)
    mv = m[vprim]
    nmv = nm[vprim]
    pos = _apply(mv, scene.positions, True)
    nrm = _apply(nmv, scene.normals, False)
    tan = torch.cat([_apply(mv, scene.tangents[:, :3], False), scene.tangents[:, 3:]], -1)
    return WorldGeometry(position=pos, normal=nrm, tangent=tan, vertex_prim=vprim)


def to_clip(world_pos, viewproj):
    """(V, 3) world -> (V, 4) clip: v4 @ viewproj.T as explicit multiply-adds."""
    x, y, z = world_pos[:, 0:1], world_pos[:, 1:2], world_pos[:, 2:3]
    return ((x * viewproj[:, 0] + y * viewproj[:, 1]) + z * viewproj[:, 2]) + viewproj[:, 3]


def object_normals_world(scene: SceneBuffers, n_object, prim_ids):
    """Object-space normals (..., 3) by their primitives' normal matrices,
    normalized (gbuf.frag:41: normalize(mat3(normal_matrix) * N))."""
    nm = scene.prim_normal_mat[prim_ids.long()][..., :3, :3]  # (..., 3, 3)
    n = (nm[..., 0] * n_object[..., 0:1] + nm[..., 1] * n_object[..., 1:2]) + (
        nm[..., 2] * n_object[..., 2:3])
    return normalize(n)
