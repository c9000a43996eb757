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
    #: () int64 tensor holding the uint32 frame index, on the frame's device
    #: (the reference's traced uint32: a captured frame reads it, so
    #: replaying the frame does not freeze it)
    frame_index: Any
    blue_noise_index: Any = 0  # () int64 tensor, frame_index % 4

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

    data: Any  # (4, AH, AW) linear color, float32 or bfloat16 (read back as float32)
    uv_offset: Any  # (N, 2) f32
    uv_scale: Any  # (N, 2) f32

    @property
    def num_textures(self) -> int:
        return self.uv_offset.shape[0]


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

    @property
    def num_primitives(self) -> int:
        return self.prim_transform.shape[0]


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


def make_temporal_state(height: int, width: int, dtype=torch.float32,
                        device="cpu") -> TemporalState:
    """Empty history of `dtype` (the reference's signature): zeros, and
    object id / normals -1 (matches nothing)."""
    return TemporalState(
        shadow_ao_history=torch.zeros((2, height, width), dtype=dtype, device=device),
        moments_history=torch.zeros((4, height, width), dtype=dtype, device=device),
        prev_normal_oid=torch.full((4, height, width), -1.0, dtype=dtype, device=device),
    )


#: PerFrameData's float fields in pack_per_frame_data's flat layout:
#: (name, shape) in order, the light's four after the camera's seven
_PFD_FLOATS = (
    ("camera_view", (4, 4)), ("camera_proj", (4, 4)), ("camera_view_inverse", (4, 4)),
    ("camera_proj_inverse", (4, 4)), ("camera_viewproj_inverse", (4, 4)),
    ("camera_view_prev_frame", (4, 4)), ("camera_proj_prev_frame", (4, 4)),
    ("projview", (4, 4)), ("direction", (4,)), ("color", (4,)), ("intensity", (4,)),
    ("display_size", (2,)), ("display_size_inverse", (2,)),
)
_LIGHT_FIELDS = ("projview", "direction", "color", "intensity")
#: length of pack_per_frame_data's float array
PER_FRAME_FLOATS = sum(int(np.prod(shape)) for _, shape in _PFD_FLOATS)


def pack_per_frame_data(
    view: np.ndarray,
    proj: np.ndarray,
    light: DirectionalLight,
    width: int,
    height: int,
    frame_index: int = 0,
    prev_view: np.ndarray | None = None,
    prev_proj: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """PerFrameData like Renderer::Render (renderer.cpp:187-205), on the
    host: (float32 flat array of _PFD_FLOATS' fields, int64 [frame index
    as uint32, frame index % 4]).  Inverses in float32, previous-frame
    matrices default to the current."""
    view = np.asarray(view, np.float32)
    proj = np.asarray(proj, np.float32)
    viewproj = proj @ view

    def host(a):
        return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, np.float32)

    fields = {
        "camera_view": view,
        "camera_proj": proj,
        "camera_view_inverse": np.linalg.inv(view).astype(np.float32),
        "camera_proj_inverse": np.linalg.inv(proj).astype(np.float32),
        "camera_viewproj_inverse": np.linalg.inv(viewproj).astype(np.float32),
        "camera_view_prev_frame": view if prev_view is None else prev_view,
        "camera_proj_prev_frame": proj if prev_proj is None else prev_proj,
        **{f: getattr(light, f) for f in _LIGHT_FIELDS},
        "display_size": np.array([width, height], np.float32),
        "display_size_inverse": np.array([1.0 / width, 1.0 / height], np.float32),
    }
    flat = np.concatenate([host(fields[name]).reshape(-1) for name, _ in _PFD_FLOATS])
    ints = np.array([int(frame_index) & 0xFFFFFFFF, int(frame_index) % 4], np.int64)
    return flat, ints


def per_frame_data_from_flat(flat, ints) -> PerFrameData:
    """The PerFrameData whose fields are views of pack_per_frame_data's two
    arrays as tensors (on any device): a frame that reads it reads those
    two buffers, which a captured frame refills every frame."""
    views, at = {}, 0
    for name, shape in _PFD_FLOATS:
        n = int(np.prod(shape))
        views[name] = flat[at:at + n].view(shape)
        at += n
    light = DirectionalLight(**{f: views.pop(f) for f in _LIGHT_FIELDS})
    return PerFrameData(**views, directional_light=light, frame_index=ints[0],
                        blue_noise_index=ints[1])


def upload_per_frame_data(flat: np.ndarray, ints: np.ndarray, device="cpu"):
    """pack_per_frame_data's arrays as tensors on `device`; to a GPU
    through pinned memory, queued on the current stream without waiting
    (the pinned blocks are not reused before their copies finish)."""
    pair = (torch.from_numpy(flat), torch.from_numpy(ints))
    if torch.device(device).type == "cpu":
        return pair
    return tuple(t.pin_memory().to(device, non_blocking=True) for t in pair)


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
    the host in float32, previous-frame matrices default to the current;
    every field a tensor on `device`, the frame index too."""
    packed = pack_per_frame_data(view, proj, light, width, height, frame_index,
                                 prev_view, prev_proj)
    return per_frame_data_from_flat(*upload_per_frame_data(*packed, device=device))
