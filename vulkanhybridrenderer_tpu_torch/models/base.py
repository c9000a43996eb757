"""Render path base (port of ``models/base.py``).

A render path registers its passes on a RenderGraph.  External resources a
path may read: "scene" (SceneBuffers on the device), "pfd" (PerFrameData),
"prim_transform" ((P, 4, 4) current primitive transforms), "bvh" (BVH8) and
"shade_tables" (ShadeTables) and "temporal_state" (TemporalState).
"""
from __future__ import annotations

from vulkanhybridrenderer_tpu_torch.core.config import RenderConfig
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RenderGraph

_REGISTRY: dict[str, type] = {}


class RenderPath:
    name: str = "base"

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if getattr(cls, "name", None) and cls.name != "base":
            _REGISTRY[cls.name] = cls

    def __init__(self, config: RenderConfig):
        self.config = config

    @property
    def uses_temporal_state(self) -> bool:
        """Whether the graph reads "temporal_state" and writes
        "TemporalStateOut" for the next frame."""
        return False

    def register(self, graph: RenderGraph) -> None:
        raise NotImplementedError

    def build_graph(self) -> RenderGraph:
        g = RenderGraph()
        self.register(g)
        return g


def get_path(name: str, config: RenderConfig) -> RenderPath:
    """Instantiate a render path by name: "hybrid", "forward", "raytraced"
    or "rayquery"."""
    from vulkanhybridrenderer_tpu_torch.models import (  # noqa: F401
        forward,
        hybrid,
        rayquery,
        raytraced,
    )

    if name not in _REGISTRY:
        raise KeyError(f"unknown render path {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](config)
