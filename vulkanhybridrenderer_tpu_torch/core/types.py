"""Core scene / frame types (port of ``vulkanhybridrenderer_tpu/core/types.py``).

Small dataclasses whose array fields are numpy arrays while a scene is built
on the host and torch tensors after one explicit ``.to(device)`` upload.
Layouts are the reference's: structure-of-arrays vertices, (P, k) primitive
and material tables, one (4, AH, AW) texture atlas.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def to_device(obj, device):
    """Recursively move a dataclass of arrays to `device`: numpy arrays become
    tensors of the same dtype, tensors are moved, other fields are kept."""
    if isinstance(obj, np.ndarray):
        # copies read-only or strided arrays; torch wants writable memory
        return torch.from_numpy(np.require(obj, requirements=["C", "W"])).to(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj,
            **{
                f.name: to_device(getattr(obj, f.name), device)
                for f in dataclasses.fields(obj)
                if f.init
            },
        )
    return obj


class _Movable:
    def to(self, device):
        return to_device(self, device)


@dataclasses.dataclass(frozen=True)
class DirectionalLight(_Movable):
    """glsl_common.h:52-57."""

    projview: Any  # (4, 4) light-space projection * view
    direction: Any  # (4,) unit direction the light travels (w unused)
    color: Any  # (4,) rgb + 1
    intensity: Any  # (4,)


@dataclasses.dataclass(frozen=True)
class PerFrameData(_Movable):
    """glsl_common.h:59-72: per-frame camera / light constants."""

    camera_view: Any
    camera_proj: Any
    camera_view_inverse: Any
    camera_proj_inverse: Any
    camera_viewproj_inverse: Any
    camera_view_prev_frame: Any
    camera_proj_prev_frame: Any
    directional_light: DirectionalLight
    display_size: Any  # (2,) f32 (w, h)
    display_size_inverse: Any  # (2,) f32
    frame_index: int  # uint32 value as a Python int
    blue_noise_index: int = 0

    @property
    def camera_position(self):
        """World-space camera origin = camera_view_inverse[:3, 3]."""
        return self.camera_view_inverse[:3, 3]


@dataclasses.dataclass(frozen=True)
class MaterialsSoA(_Movable):
    """glsl_common.h:83-92 as (P,)-tables.  Texture slots hold -1 for 'none'."""

    base_color: Any  # (P, 4)
    base_color_texture: Any  # (P,) int32
    metallic_roughness_texture: Any  # (P,) int32
    normal_map: Any  # (P,) int32
    metallic_factor: Any  # (P,)
    roughness_factor: Any  # (P,)
    alpha_mask: Any  # (P,) int32 (1 = masked)
    alpha_cutoff: Any  # (P,)


@dataclasses.dataclass(frozen=True)
class TextureAtlas(_Movable):
    """All scene textures packed into one (4, AH, AW) array; texture t's texel
    = uv_offset[t] + wrap(uv) * uv_scale[t] (in texels)."""

    data: Any  # (4, AH, AW) float32, linear color
    uv_offset: Any  # (N, 2) f32
    uv_scale: Any  # (N, 2) f32


@dataclasses.dataclass(frozen=True)
class SceneBuffers(_Movable):
    """The scene: SoA vertices, flattened triangle list, primitive table,
    materials, atlas."""

    positions: Any  # (V, 3)
    normals: Any  # (V, 3)
    tangents: Any  # (V, 4)
    uv0: Any  # (V, 2)
    uv1: Any  # (V, 2)
    indices: Any  # (I,) int32
    prim_vertex_offset: Any  # (P,) int32
    prim_index_offset: Any  # (P,) int32
    prim_index_count: Any  # (P,) int32
    tri_vertex: Any  # (T, 3) int32 global vertex ids
    tri_prim: Any  # (T,) int32
    prim_transform: Any  # (P, 4, 4)
    prim_normal_mat: Any  # (P, 4, 4)
    materials: MaterialsSoA
    atlas: TextureAtlas
    alpha_tri_idx: Any  # (A,) int32
    has_alpha_mask: bool = False
    has_normal_maps: bool = True
    has_mr_textures: bool = True

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_vertex.shape[0]


@dataclasses.dataclass(frozen=True)
class GBuffer:
    """Hybrid-path G-buffer attachments, channel-planar."""

    albedo: Any  # (4, H, W)
    normal_oid: Any  # (4, H, W) world normal xyz + object id
    motion_mr: Any  # (4, H, W) motion xy + metallic + roughness
    depth: Any  # (H, W) reverse-Z depth (0 = far / sky)


@dataclasses.dataclass(frozen=True)
class TemporalState(_Movable):
    """SVGF cross-frame state (the reference's storage-image history,
    hybrid_render_path.cpp:245-262), carried from one frame to the next."""

    shadow_ao_history: Any  # (2, H, W) integrated shadow (0) and AO (1)
    moments_history: Any  # (4, H, W) shadow m1, m2, ao m1, m2
    prev_normal_oid: Any  # (4, H, W) previous frame's world normals + object id


def make_temporal_state(height: int, width: int, device="cpu") -> TemporalState:
    """Empty history: zeros, and object id / normals -1 (matches nothing)."""
    return TemporalState(
        shadow_ao_history=torch.zeros((2, height, width), device=device),
        moments_history=torch.zeros((4, height, width), device=device),
        prev_normal_oid=torch.full((4, height, width), -1.0, device=device),
    )


def make_per_frame_data(
    view: np.ndarray,
    proj: np.ndarray,
    light: DirectionalLight,
    width: int,
    height: int,
    frame_index: int = 0,
    prev_view: np.ndarray | None = None,
    prev_proj: np.ndarray | None = None,
    device="cpu",
) -> PerFrameData:
    """PerFrameData like Renderer::Render (renderer.cpp:187-205): inverses on
    the host in float32, previous-frame matrices default to the current."""
    view = np.asarray(view, np.float32)
    proj = np.asarray(proj, np.float32)
    viewproj = proj @ view

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return PerFrameData(
        camera_view=t(view),
        camera_proj=t(proj),
        camera_view_inverse=t(np.linalg.inv(view).astype(np.float32)),
        camera_proj_inverse=t(np.linalg.inv(proj).astype(np.float32)),
        camera_viewproj_inverse=t(np.linalg.inv(viewproj).astype(np.float32)),
        camera_view_prev_frame=t(view if prev_view is None else prev_view),
        camera_proj_prev_frame=t(proj if prev_proj is None else prev_proj),
        directional_light=light.to(device),
        display_size=t(np.array([width, height], np.float32)),
        display_size_inverse=t(np.array([1.0 / width, 1.0 / height], np.float32)),
        frame_index=int(frame_index) & 0xFFFFFFFF,
        blue_noise_index=int(frame_index) % 4,
    )
