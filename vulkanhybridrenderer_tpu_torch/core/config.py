"""Render configuration (port of ``vulkanhybridrenderer_tpu/core/config.py``).

Same enums, dataclasses and field names as the reference, so one set of knobs
reads the same in both packages.  The bf16 BVH table and the VMEM-budget leaf
auto-select are TPU residency levers and are not ported: the port accepts
only ``bvh_dtype="f32"`` and ``bvh_leaf_max`` 0 or 8 (0 means 8).
"""
from __future__ import annotations

import dataclasses
import enum


class ShadowMode(enum.IntEnum):  # common.glsl:13-16
    RAYTRACED = 0
    RASTERIZED = 1
    OFF = 2


class AmbientOcclusionMode(enum.IntEnum):  # common.glsl:18-21
    RAYTRACED = 0
    SSAO = 1
    OFF = 2


class ReflectionMode(enum.IntEnum):  # common.glsl:23-26
    RAYTRACED = 0
    SSR = 1
    OFF = 2


@dataclasses.dataclass(frozen=True)
class SSAOSettings:
    radius: float = 0.75


@dataclasses.dataclass(frozen=True)
class SSRSettings:
    ray_distance: float = 20.0
    step_size: float = 0.1
    thickness: float = 0.75
    bsearch_steps: int = 4


@dataclasses.dataclass(frozen=True)
class HybridSettings:
    """Hybrid path modes (defaults: RT shadows on, AO, reflections and denoise
    off, hybrid_render_path.h:32-35)."""

    shadow_mode: ShadowMode = ShadowMode.RAYTRACED
    ao_mode: AmbientOcclusionMode = AmbientOcclusionMode.OFF
    reflection_mode: ReflectionMode = ReflectionMode.OFF
    denoise: bool = False
    ssao: SSAOSettings = dataclasses.field(default_factory=SSAOSettings)
    ssr: SSRSettings = dataclasses.field(default_factory=SSRSettings)
    rt_scale: int = 1


@dataclasses.dataclass(frozen=True)
class ForwardSettings:
    msaa_samples: int = 1
    msaa_mode: str = "coverage"


@dataclasses.dataclass(frozen=True)
class RaytracedSettings:
    test_alpha: bool = False


@dataclasses.dataclass(frozen=True)
class RayquerySettings:
    pass


@dataclasses.dataclass(frozen=True)
class RasterState:
    cull_mode: str = "back"  # "back" | "none"
    depth_compare: str = "greater_equal"
    depth_clear: float = 0.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level configuration of one frame."""

    width: int = 1920
    height: int = 1080
    animated: bool = False
    raster: str = "binned"
    #: "off" rasters alpha-masked geometry solid (the only mode the port
    #: carries so far); "brute" is the binned alpha depth-peel
    alpha_raster: str = "brute"
    alpha_peel_rounds: int = 4
    shadow_map_size: int = 4096
    shadow_accel: str = "bvh8"
    #: triangles per BVH8 leaf row: 0 (= 8) or 8
    bvh_leaf_max: int = 0
    bvh_dtype: str = "f32"
    ao_rays: int = 2
    raster_state: RasterState = dataclasses.field(default_factory=RasterState)
    hybrid: HybridSettings = dataclasses.field(default_factory=HybridSettings)
    forward: ForwardSettings = dataclasses.field(default_factory=ForwardSettings)
    raytraced: RaytracedSettings = dataclasses.field(default_factory=RaytracedSettings)
    rayquery: RayquerySettings = dataclasses.field(default_factory=RayquerySettings)

    def __post_init__(self):
        if self.bvh_leaf_max not in (0, 8):
            raise ValueError(
                f"bvh_leaf_max={self.bvh_leaf_max}: the port builds 8-triangle "
                "leaf rows only (0 means 8)"
            )
        if self.bvh_dtype != "f32":
            raise ValueError(
                f"bvh_dtype={self.bvh_dtype!r}: the port traces f32 tables only"
            )
