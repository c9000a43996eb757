"""Carry scenes and BVH tables over from plain numpy arrays.

The reference package's scene, binary BVH, BVH8 and SVGF history are
pytrees of arrays; converted to numpy (for instance with
``dataclasses.asdict`` and ``np.asarray``) they build the port's host
objects here, so both packages can render and trace from exactly the same
arrays.  Nothing in this module imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.core.types import (
    DirectionalLight,
    MaterialsSoA,
    SceneBuffers,
    TemporalState,
    TextureAtlas,
)
from vulkanhybridrenderer_tpu_torch.ops.bvh import BVH
from vulkanhybridrenderer_tpu_torch.ops.bvh8 import BVH8
from vulkanhybridrenderer_tpu_torch.scene.gltf import Camera, Scene


def _arrays(cls, fields: Mapping[str, Any], **nested):
    kw = {}
    for name in cls.__dataclass_fields__:
        if name in nested:
            kw[name] = nested[name]
        elif isinstance(fields[name], (bool, np.bool_)):
            kw[name] = bool(fields[name])
        else:
            kw[name] = np.asarray(fields[name])
    return cls(**kw)


def scene_from_numpy(name: str, buffers: Mapping[str, Any],
                     camera: Mapping[str, Any], light: Mapping[str, Any]) -> Scene:
    """buffers: the SceneBuffers fields by name, with "materials" and "atlas"
    as nested mappings of their fields; camera: Camera fields; light:
    DirectionalLight fields.  Returns the port's host Scene."""
    materials = _arrays(MaterialsSoA, buffers["materials"])
    atlas = _arrays(TextureAtlas, buffers["atlas"])
    sb = _arrays(SceneBuffers, buffers, materials=materials, atlas=atlas)
    cam = Camera(**{
        k: (np.asarray(v, np.float32) if k == "position" else float(v))
        for k, v in camera.items()
    })
    return Scene(name=name, buffers=sb, camera=cam,
                 light=_arrays(DirectionalLight, light))


def bvh_from_numpy(fields: Mapping[str, Any], leaf_size: int) -> BVH:
    """A binary BVH from its fields by name (aabb_min, aabb_max, left,
    right, escape, leaf_tri, order and, where present and not None, next8
    and esc8) as CPU tensors of the reference's dtypes."""
    def t(name):
        a = fields.get(name)
        return None if a is None else torch.from_numpy(np.array(a))  # a writable copy

    return BVH(**{f: t(f) for f in ("aabb_min", "aabb_max", "left", "right", "escape",
                                    "leaf_tri", "order", "next8", "esc8")},
               leaf_size=int(leaf_size))


def bvh8_from_numpy(rows, depth: int, leaf_max: int) -> BVH8:
    """A BVH8 over an (N, 128) float32 row table built elsewhere, with its
    refit metadata read from the rows."""
    if leaf_max != 8:
        raise ValueError("the port traces 8-triangle leaf rows only")
    rows = torch.from_numpy(np.array(rows, np.float32))  # a writable copy
    return BVH8.from_rows(rows, int(depth), int(leaf_max))


def temporal_state_from_numpy(shadow_ao_history, moments_history,
                              prev_normal_oid) -> TemporalState:
    """An SVGF history, (2, H, W), (4, H, W) and (4, H, W) float32, as CPU
    tensors (the fields of the reference's TemporalState)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    return TemporalState(shadow_ao_history=t(shadow_ao_history),
                         moments_history=t(moments_history),
                         prev_normal_oid=t(prev_normal_oid))
