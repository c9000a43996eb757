"""Frame driver (port of ``runtime/renderer.py``, the parts the slice runs).

Owns the device copy of the scene, the render graph of the active path, the
previous-frame matrices, the BVH8 and the shade tables.  ``render_frame``
runs the graph eagerly on ``device``; nothing is compiled ahead of time.
"""
from __future__ import annotations

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.core.config import RenderConfig
from vulkanhybridrenderer_tpu_torch.core.types import PerFrameData, make_per_frame_data
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT
from vulkanhybridrenderer_tpu_torch.models.base import get_path
from vulkanhybridrenderer_tpu_torch.scene.gltf import Scene


def _encode_srgb8(planar):
    """(4, H, W) linear -> (H, W, 4) uint8 sRGB (the swapchain conversion)."""
    img = torch.clamp(planar.permute(1, 2, 0), 0.0, 1.0)
    rgb = img[..., :3]
    srgb = torch.where(
        rgb <= 0.0031308, rgb * 12.92, 1.055 * rgb ** (1.0 / 2.4) - 0.055
    )
    out = torch.cat([srgb, img[..., 3:4]], dim=-1)
    return torch.round(out * 255.0).to(torch.uint8)


class Renderer:
    def __init__(self, scene: Scene, config: RenderConfig | None = None,
                 path: str = "hybrid", device="cuda"):
        """device: where the frame runs.  The scene is uploaded once; the BVH
        is built on the host at the first frame."""
        self.scene = scene
        self.config = config or RenderConfig()
        self.device = torch.device(device)
        self.buffers = scene.buffers.to(self.device)
        self.prim_transform = self.buffers.prim_transform
        self.path = get_path(path, self.config)
        self.graph = self.path.build_graph()
        self.frame_index = 0
        self._prev_view: np.ndarray | None = None
        self._prev_proj: np.ndarray | None = None
        self._bvh = None
        self._shade_tables = None

    def _make_pfd(self) -> PerFrameData:
        cam = self.scene.camera
        view = cam.view()
        proj = cam.projection(aspect=self.config.width / self.config.height)
        pfd = make_per_frame_data(
            view, proj, self.scene.light, self.config.width, self.config.height,
            frame_index=self.frame_index, prev_view=self._prev_view,
            prev_proj=self._prev_proj, device=self.device,
        )
        self._prev_view, self._prev_proj = view, proj
        return pfd

    def _get_bvh(self):
        """BVH8 over the world triangles, built once on the host (SAH +
        8-wide collapse, f32 rows, 8-triangle leaves) and uploaded."""
        if self._bvh is None:
            from vulkanhybridrenderer_tpu_torch.ops import bvh as bvh_ops
            from vulkanhybridrenderer_tpu_torch.ops import bvh8 as bvh8_ops
            from vulkanhybridrenderer_tpu_torch.ops.geometry import to_world

            world = to_world(self.buffers, self.prim_transform)
            tris = bvh_ops.world_triangles(world.position, self.buffers.tri_vertex)
            self._bvh = bvh8_ops.build_bvh8_host(tris.cpu().numpy()).to(self.device)
        return self._bvh

    def _get_shade_tables(self):
        if self._shade_tables is None:
            from vulkanhybridrenderer_tpu_torch.ops import shadetab

            self._shade_tables = shadetab.build_shade_tables(self.buffers)
        return self._shade_tables

    def _resources(self, pfd):
        return {
            "scene": self.buffers,
            "pfd": pfd,
            "prim_transform": self.prim_transform,
            "bvh": self._get_bvh(),
            "shade_tables": self._get_shade_tables(),
        }

    def render_frame(self, srgb8: bool = False):
        """Render one frame; returns the (4, H, W) linear RENDER_OUTPUT on the
        device, or with srgb8=True the (H, W, 4) uint8 sRGB image.  The work
        is queued on the current stream; the caller synchronizes."""
        out = self.graph.run(self._resources(self._make_pfd()))[RENDER_OUTPUT]
        self.frame_index += 1
        return _encode_srgb8(out) if srgb8 else out

    def fetch_resources(self, *names: str) -> dict:
        """Render one frame and return the named graph resources (the
        reference's debug-texture view)."""
        res = self.graph.run(self._resources(self._make_pfd()))
        self.frame_index += 1
        return {n: res[n] for n in names}

    def time_passes(self, iters: int = 5) -> dict[str, float]:
        """Per-pass milliseconds (device time between synchronizations on a
        GPU).  Uses one frame's PerFrameData and does not advance the frame."""
        prev = (self._prev_view, self._prev_proj)
        pfd = self._make_pfd()
        self._prev_view, self._prev_proj = prev
        return self.graph.time_passes(self._resources(pfd), self.device, iters=iters)
