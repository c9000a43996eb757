"""Frame driver (port of ``runtime/renderer.py``, the parts the slice runs).

Owns the device copy of the scene, the render graphs, the previous-frame
matrices, the BVH8, the shade tables and the SVGF temporal state.
``render_frame`` runs the active graph eagerly on ``device``; nothing is
compiled ahead of time.  A graph is built once per (path, config), as the
reference caches its compiled frame functions, so switching back with
``set_path`` / ``set_config`` reuses it.  The temporal state lives at trace
resolution (1/rt_scale of the frame on the hybrid path): it is made at
construction, passed into the graph as "temporal_state", replaced by the
graph's "TemporalStateOut" after each rendered frame, and made anew when
``set_config`` changes its size.  ``update_camera`` is the fly camera.
"""
from __future__ import annotations

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.core.config import RenderConfig
from vulkanhybridrenderer_tpu_torch.core.types import (
    PerFrameData,
    make_per_frame_data,
    make_temporal_state,
)
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT
from vulkanhybridrenderer_tpu_torch.models.base import get_path
from vulkanhybridrenderer_tpu_torch.runtime import camera as cam_ctl
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
        self.path_name = path
        self._graphs: dict = {}
        self.temporal_state = self._new_temporal_state()
        self.frame_index = 0
        self._prev_view: np.ndarray | None = None
        self._prev_proj: np.ndarray | None = None
        self._bvh = None
        self._shade_tables = None
        self.path, self.graph = self._get_graph(path, self.config)

    def _temporal_dims(self) -> tuple[int, int]:
        """SVGF's temporal state lives at trace resolution: the frame's, or
        1/rt_scale of it (rounded up) when the hybrid path traces half-res."""
        rs = max(1, self.config.hybrid.rt_scale)
        return -(-self.config.height // rs), -(-self.config.width // rs)

    def _new_temporal_state(self):
        return make_temporal_state(*self._temporal_dims(), self.device)

    def _get_graph(self, name: str, config: RenderConfig):
        """(path, graph) of one (path name, config), built on first use."""
        key = (name, config)
        if key not in self._graphs:
            path = get_path(name, config)
            self._graphs[key] = (path, path.build_graph())
        return self._graphs[key]

    def set_path(self, name: str):
        """Switch the render path (renderer.cpp:159-181)."""
        self.path, self.graph = self._get_graph(name, self.config)
        self.path_name = name

    def set_config(self, config: RenderConfig):
        """Switch the configuration (the reference's pipeline rebuild); the
        temporal state is made anew when its size changes."""
        old_dims = self._temporal_dims()
        self.path, self.graph = self._get_graph(self.path_name, config)
        self.config = config
        if self._temporal_dims() != old_dims:
            self.temporal_state = self._new_temporal_state()

    def update_camera(self, dt: float, keys=frozenset(), mouse_delta=(0.0, 0.0),
                      mouse_down: bool = False):
        """The fly camera (runtime/camera.py) on the scene's camera."""
        cam_ctl.update_camera(self.scene.camera, dt, keys, mouse_delta, mouse_down)

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
            "temporal_state": self.temporal_state,
        }

    def render_frame(self, srgb8: bool = False):
        """Render one frame; returns the (4, H, W) linear RENDER_OUTPUT on the
        device, or with srgb8=True the (H, W, 4) uint8 sRGB image.  The work
        is queued on the current stream; the caller synchronizes."""
        res = self.graph.run(self._resources(self._make_pfd()))
        if self.path.uses_temporal_state:
            self.temporal_state = res["TemporalStateOut"]
        self.frame_index += 1
        out = res[RENDER_OUTPUT]
        return _encode_srgb8(out) if srgb8 else out

    def fetch_resources(self, *names: str) -> dict:
        """Render one frame and return the named graph resources (the
        reference's debug-texture view).  Like the reference's, it leaves the
        temporal state as it was."""
        res = self.graph.run(self._resources(self._make_pfd()))
        self.frame_index += 1
        return {n: res[n] for n in names}

    def time_passes(self, iters: int = 5) -> dict[str, float]:
        """Per-pass milliseconds (device time between synchronizations on a
        GPU).  Uses one frame's PerFrameData and advances neither the frame
        nor the temporal state."""
        prev = (self._prev_view, self._prev_proj)
        pfd = self._make_pfd()
        self._prev_view, self._prev_proj = prev
        return self.graph.time_passes(self._resources(pfd), self.device, iters=iters)
