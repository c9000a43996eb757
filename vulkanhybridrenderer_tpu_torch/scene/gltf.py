"""Host scene assembly (the scene part of ``scene/gltf.py``).

Camera, light and SceneBuffers construction shared by the procedural scenes.
Arrays stay numpy until the renderer uploads the scene with one
``Scene.buffers.to(device)``.  The GLB reader is not ported yet (ROADMAP
item 17).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from vulkanhybridrenderer_tpu_torch.core.types import (
    DirectionalLight,
    MaterialsSoA,
    SceneBuffers,
)
from vulkanhybridrenderer_tpu_torch.scene.atlas import build_atlas
from vulkanhybridrenderer_tpu_torch.utils import math3d as m3


@dataclasses.dataclass
class Camera:
    """Host-side camera (reference Scene::camera)."""

    yfov: float = np.deg2rad(60.0)
    znear: float = 0.1
    aspect: float = 16.0 / 9.0
    yaw: float = 0.0
    pitch: float = 0.0
    roll: float = 0.0
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )

    def transform(self) -> np.ndarray:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = self.position
        return t @ m3.yaw_pitch_roll(self.yaw, self.pitch, self.roll)

    def view(self) -> np.ndarray:
        return np.linalg.inv(self.transform()).astype(np.float32)

    def projection(self, aspect: float | None = None) -> np.ndarray:
        return m3.infinite_reverse_z_projection(
            self.yfov, self.aspect if aspect is None else aspect, self.znear
        )


@dataclasses.dataclass
class Scene:
    """Host-side scene: buffers + camera + light + name."""

    name: str
    buffers: SceneBuffers
    camera: Camera
    light: DirectionalLight


def make_directional_light(
    direction, color=(1.0, 1.0, 1.0), intensity=30.0
) -> DirectionalLight:
    """scene_loader.cpp:84-99."""
    direction = np.asarray(direction, np.float32)
    direction = direction / np.linalg.norm(direction)
    light_perspective = m3.ortho(-8.0, 8.0, -8.0, 8.0, 12.0, 0.1)
    light_view = m3.look_at(-direction * 12.0, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    return DirectionalLight(
        projview=(light_perspective @ light_view).astype(np.float32),
        direction=np.append(direction, 0.0).astype(np.float32),
        color=np.append(np.asarray(color, np.float32), 1.0).astype(np.float32),
        intensity=np.full((4,), float(intensity), np.float32),
    )


def build_scene_buffers(
    positions: np.ndarray,
    normals: np.ndarray,
    tangents: np.ndarray,
    uv0: np.ndarray,
    uv1: np.ndarray,
    indices: np.ndarray,
    primitives: list[dict],
    images: list[np.ndarray] | None = None,
    srgb: list[bool] | None = None,
) -> SceneBuffers:
    """Assemble host SceneBuffers.  primitives: dicts with transform (4, 4),
    vertex_offset, index_offset, index_count and the material fields
    (glsl_common.h:94-99)."""
    num_prims = len(primitives)
    prim_transform = np.stack(
        [np.asarray(p["transform"], np.float32) for p in primitives]
    )
    prim_normal = np.stack([m3.normal_matrix(t) for t in prim_transform])

    def field(name, default):
        return np.asarray([p.get(name, default) for p in primitives], np.float32)

    def ifield(name, default):
        return np.asarray([p.get(name, default) for p in primitives], np.int32)

    materials = MaterialsSoA(
        base_color=(
            np.stack(
                [np.asarray(p.get("base_color", (1, 1, 1, 1)), np.float32)
                 for p in primitives]
            )
            if num_prims
            else np.zeros((0, 4), np.float32)
        ),
        base_color_texture=ifield("base_color_texture", -1),
        metallic_roughness_texture=ifield("metallic_roughness_texture", -1),
        normal_map=ifield("normal_map", -1),
        metallic_factor=field("metallic_factor", 1.0),
        roughness_factor=field("roughness_factor", 1.0),
        alpha_mask=ifield("alpha_mask", 0),
        alpha_cutoff=field("alpha_cutoff", 0.0),
    )

    vtx_off = ifield("vertex_offset", 0)
    idx_off = ifield("index_offset", 0)
    idx_cnt = ifield("index_count", 0)

    # flatten to the global triangle list the rasterizer and BVH consume
    indices = np.asarray(indices, np.int32)
    tri_vertex, tri_prim = [], []
    for p in range(num_prims):
        idx = indices[idx_off[p] : idx_off[p] + idx_cnt[p]].reshape(-1, 3)
        tri_vertex.append(idx + vtx_off[p])
        tri_prim.append(np.full(len(idx), p, np.int32))
    tri_vertex = (
        np.concatenate(tri_vertex) if tri_vertex else np.zeros((0, 3), np.int32)
    )
    tri_prim = np.concatenate(tri_prim) if tri_prim else np.zeros((0,), np.int32)

    tri_masked = (
        materials.alpha_mask[tri_prim] == 1 if len(tri_prim) else np.zeros(0, bool)
    )
    alpha_tri_idx = np.nonzero(tri_masked)[0].astype(np.int32)

    return SceneBuffers(
        positions=np.asarray(positions, np.float32),
        normals=np.asarray(normals, np.float32),
        tangents=np.asarray(tangents, np.float32),
        uv0=np.asarray(uv0, np.float32),
        uv1=np.asarray(uv1, np.float32),
        indices=indices,
        prim_vertex_offset=vtx_off,
        prim_index_offset=idx_off,
        prim_index_count=idx_cnt,
        tri_vertex=tri_vertex.astype(np.int32),
        tri_prim=tri_prim,
        prim_transform=prim_transform,
        prim_normal_mat=prim_normal,
        materials=materials,
        atlas=build_atlas(images or [], srgb),
        alpha_tri_idx=alpha_tri_idx,
        has_alpha_mask=bool(alpha_tri_idx.size),
        has_normal_maps=bool((materials.normal_map >= 0).any()),
        has_mr_textures=bool((materials.metallic_roughness_texture >= 0).any()),
    )
