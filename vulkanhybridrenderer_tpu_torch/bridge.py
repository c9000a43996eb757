"""Carry scenes and BVH tables over from plain numpy arrays.

The reference package's scene and BVH8 are pytrees of arrays; converted to
numpy (for instance with ``dataclasses.asdict`` and ``np.asarray``) they build
the port's host objects here, so both packages can render from exactly the
same arrays.  Nothing in this module imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.core.types import (
    DirectionalLight,
    MaterialsSoA,
    SceneBuffers,
    TextureAtlas,
)
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


def bvh8_from_numpy(rows, depth: int, leaf_max: int) -> BVH8:
    """A BVH8 over an (N, 128) float32 row table built elsewhere."""
    if leaf_max != 8:
        raise ValueError("the port traces 8-triangle leaf rows only")
    rows = torch.from_numpy(np.array(rows, np.float32))  # a writable copy
    return BVH8(rows=rows, depth=int(depth), leaf_max=int(leaf_max))
