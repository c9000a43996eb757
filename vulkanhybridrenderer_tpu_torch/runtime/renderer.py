"""Frame driver (port of ``runtime/renderer.py``, the parts the slice runs).

Owns the device copy of the scene, the render graphs, the previous-frame
matrices, the BVH8, the shadow grid, the shade tables and the SVGF temporal
state.  ``animate`` sets the primitive transforms of the next frames; a
configuration with ``animated=True`` refits the BVH8 (and rebuilds the
shadow grid) every frame, and its graph is kept apart from the static one,
since graphs are keyed on the whole configuration.
``render_frame(sync=True, srgb8=False)``, the reference's signature, runs the
active graph eagerly on ``device``; nothing is compiled ahead of time.  A
graph is built once per (path, config), as the reference caches its compiled
frame functions, so switching back with ``set_path`` / ``set_config`` reuses
it.  The temporal state lives at trace
resolution (1/rt_scale of the frame on the hybrid path): it is made at
construction, passed into the graph as "temporal_state", replaced by the
graph's "TemporalStateOut" after each rendered frame, and made anew when
``set_config`` changes its size.  ``update_camera`` is the fly camera.

Observability: ``stats`` (per-pass EMA timings fed by ``time_passes``, and
the frame-time EMA), ``list_resources``, ``fetch_resource`` /
``fetch_resources``, ``debug_dump``, ``save_frame``,
``profile`` (a ``torch.profiler`` Chrome trace) and ``find_nonfinite_pass``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.core.config import RenderConfig
from vulkanhybridrenderer_tpu_torch.core.types import (
    PerFrameData,
    make_per_frame_data,
    make_temporal_state,
)
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT, PassStats
from vulkanhybridrenderer_tpu_torch.models.base import get_path
from vulkanhybridrenderer_tpu_torch.runtime import camera as cam_ctl
from vulkanhybridrenderer_tpu_torch.scene.gltf import Scene
from vulkanhybridrenderer_tpu_torch.utils.image import save_png


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
        self._shadow_grid = None  # (light direction, ShadowGrid)
        self._shade_tables = None
        self._blue_noise = None
        self._stats = PassStats()
        #: (start, end) CUDA events of frames whose time is not read yet
        self._frame_events: collections.deque = collections.deque()
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
        """BVH8 over the world triangles, built once (f32 rows, 8-triangle
        leaves) and uploaded: the host SAH build and the native collapse
        where the native build is available, else, as the reference's
        (runtime/renderer.py:200-203), the LBVH built on the renderer's
        device and collapsed in Python."""
        if self._bvh is None:
            from vulkanhybridrenderer_tpu_torch import native_bridge
            from vulkanhybridrenderer_tpu_torch.ops import bvh as bvh_ops
            from vulkanhybridrenderer_tpu_torch.ops import bvh8 as bvh8_ops
            from vulkanhybridrenderer_tpu_torch.ops.geometry import to_world

            world = to_world(self.buffers, self.prim_transform)
            tris = bvh_ops.world_triangles(world.position, self.buffers.tri_vertex)
            if native_bridge.native_available():
                b8 = bvh8_ops.build_bvh8_sah_host(tris.cpu().numpy())
            else:
                b8 = bvh8_ops.build_bvh8_host(bvh_ops.build(tris, leaf_size=1),
                                              tris.cpu().numpy())
            self._bvh = b8.to(self.device)
        return self._bvh

    def _get_shadow_grid(self):
        """The light-space shadow grid of ``shadow_accel="grid"``
        (ops/shadowgrid.py), sized on the host from the scene's world
        triangles and built on the device.  Its frame follows the light, so it
        is kept per light direction and rebuilt when the light turns; animated
        scenes rebuild it in-frame at the same resolution (models/hybrid.py,
        Shadow Grid Build)."""
        light = tuple(np.asarray(self.scene.light.direction[:3], np.float32).tolist())
        if self._shadow_grid is None or self._shadow_grid[0] != light:
            from vulkanhybridrenderer_tpu_torch.ops import bvh as bvh_ops
            from vulkanhybridrenderer_tpu_torch.ops import shadowgrid
            from vulkanhybridrenderer_tpu_torch.ops.geometry import to_world

            world = to_world(self.buffers, self.prim_transform)
            tris = bvh_ops.world_triangles(world.position, self.buffers.tri_vertex)
            self._shadow_grid = (light, shadowgrid.build_shadow_grid(tris, light))
        return self._shadow_grid[1]

    def _uses_shadow_grid(self) -> bool:
        """Whether the active graph reads the grid (models/hybrid.py's
        use_grid): the "shadow_grid" resource exists only then."""
        from vulkanhybridrenderer_tpu_torch.core.config import ShadowMode

        return (self.config.shadow_accel == "grid" and self.path_name == "hybrid"
                and self.config.hybrid.shadow_mode == ShadowMode.RAYTRACED)

    def animate(self, prim_transform):
        """Set this frame's primitive transforms (P, 4, 4), numpy or a tensor,
        moved to the renderer's device (animated scenes: with
        ``config.animated`` the BVH8 is refit, and the shadow grid rebuilt,
        every frame from the moved triangles)."""
        self.prim_transform = torch.as_tensor(prim_transform, dtype=torch.float32,
                                              device=self.device)

    def _get_shade_tables(self):
        if self._shade_tables is None:
            from vulkanhybridrenderer_tpu_torch.ops import shadetab

            self._shade_tables = shadetab.build_shade_tables(self.buffers)
        return self._shade_tables

    def _resources(self, pfd):
        res = {
            "scene": self.buffers,
            "pfd": pfd,
            "prim_transform": self.prim_transform,
            "bvh": self._get_bvh(),
            "shade_tables": self._get_shade_tables(),
            "temporal_state": self.temporal_state,
        }
        if self._uses_shadow_grid():
            res["shadow_grid"] = self._get_shadow_grid()
        return res

    @property
    def blue_noise(self):
        """(4, 128, 128, 4) blue-noise texture stack on the renderer's device,
        generated at first access (the reference uploads four prebaked
        LDR_RGBA PNGs, renderer.cpp:32-36).  No pass reads it; it rides along
        for user pipelines, so neither the constructor nor a frame makes it."""
        if self._blue_noise is None:
            from vulkanhybridrenderer_tpu_torch.utils.bluenoise import blue_noise_rgba

            stack = np.stack([blue_noise_rgba(128, seed=i) for i in range(4)])
            self._blue_noise = torch.from_numpy(stack).to(self.device)
        return self._blue_noise

    @property
    def stats(self) -> PassStats:
        """Per-pass EMA timings (fed by time_passes) and the frame-time EMA.
        On a GPU a frame's time comes from CUDA events recorded around it and
        is read once they have completed, so no frame waits for it."""
        self._read_frame_times()
        return self._stats

    def _read_frame_times(self):
        while self._frame_events and self._frame_events[0][1].query():
            start, end = self._frame_events.popleft()
            self._stats.update_frame(start.elapsed_time(end))

    def render_frame(self, sync: bool = True, srgb8: bool = False):
        """Render one frame; returns the (4, H, W) linear RENDER_OUTPUT on the
        device, or with srgb8=True the (H, W, 4) uint8 sRGB image.  The work
        is queued on the device's current stream; with sync=True (the
        reference's jax.block_until_ready) it returns once the frame has
        finished there, with sync=False once it is queued.  Both give the same
        frame."""
        cuda = self.device.type == "cuda"
        if cuda:
            self._read_frame_times()
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        else:
            t0 = time.perf_counter()
        res = self.graph.run(self._resources(self._make_pfd()))
        if self.path.uses_temporal_state:
            self.temporal_state = res["TemporalStateOut"]
        self.frame_index += 1
        out = res[RENDER_OUTPUT]
        out = _encode_srgb8(out) if srgb8 else out
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self._frame_events.append((start, end))
            if sync:
                stream.synchronize()
        else:
            self._stats.update_frame((time.perf_counter() - t0) * 1e3)
        return out

    def fetch_resources(self, *names: str) -> dict:
        """Render one frame and return the named graph resources (the
        reference's debug-texture view).  Like the reference's, it renders
        at the current frame index and leaves it, and the temporal state,
        as they were; the previous view becomes the current camera's."""
        res = self.graph.run(self._resources(self._make_pfd()))
        return {n: res[n] for n in names}

    def fetch_resource(self, *names: str):
        """The reference's fetch_resource: the named resources of one frame
        (one graph run), a tensor for one name, else a tuple in the names'
        order.  The frame index, temporal state and previous view change as
        in fetch_resources."""
        res = self.fetch_resources(*names)
        return res[names[0]] if len(names) == 1 else tuple(res[n] for n in names)

    def time_passes(self, iters: int = 5) -> dict[str, float]:
        """Per-pass milliseconds (device time between synchronizations on a
        GPU).  Uses one frame's PerFrameData and advances neither the frame
        nor the temporal state; as the reference's, the previous view
        becomes the current camera's."""
        pfd = self._make_pfd()
        timings = self.graph.time_passes(self._resources(pfd), self.device, iters=iters)
        self._stats.update(timings)
        return timings

    def list_resources(self) -> list[str]:
        """Every named resource the active graph produces, in execution order
        (the debug-texture dropdown, user_interface.cpp:129-150)."""
        out: list[str] = []
        for name in self.graph.find_execution_order():
            out.extend(self.graph.passes[name].outputs)
        return out

    def debug_dump(self, resource: str, path, srgb: bool = True) -> np.ndarray:
        """Render one frame and save the named graph resource as a PNG (the
        reference's debug-texture viewer); returns it as numpy."""
        arr = self.fetch_resource(resource).cpu().numpy()
        save_png(path, arr, srgb=srgb)
        return arr

    def save_frame(self, path) -> np.ndarray:
        """Render one frame and save it as an sRGB PNG; returns it as numpy."""
        img = self.render_frame().cpu().numpy()
        save_png(path, img)
        return img

    def profile(self, trace_dir="/tmp/vhr_trace", frames: int = 3):
        """A torch.profiler trace of `frames` frames (after one untraced
        frame), written as the Chrome trace
        ``<trace_dir>/<path>_frame<index>.json`` (the renderer's path name and
        its frame index after the traced frames); returns `trace_dir`, as
        the reference does.  The counterpart of the reference's RenderDoc
        labels."""
        from torch.profiler import ProfilerActivity, profile

        self.render_frame()
        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            for _ in range(frames):
                self.render_frame(sync=False)
            if cuda:
                torch.cuda.synchronize(self.device)
        out = Path(trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{self.path_name}_frame{self.frame_index}.json"))
        return trace_dir

    def find_nonfinite_pass(self) -> str | None:
        """Run the active graph's passes one by one, in execution order, on
        one frame's resources; return the first pass with a float output that
        is not all finite, or None when the frame is clean."""
        res = self._resources(self._make_pfd())
        for name in self.graph.find_execution_order():
            p = self.graph.passes[name]
            produced = p.fn(res)
            for out_name in p.outputs:
                if not all(bool(torch.isfinite(t).all())
                           for t in _float_tensors(produced[out_name])):
                    return name
            res.update({k: produced[k] for k in p.outputs})
        return None


def _float_tensors(obj):
    """The floating-point tensors in a resource: a tensor, or the fields and
    items of dataclasses, dicts, lists and tuples, recursively."""
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _float_tensors(getattr(obj, f.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _float_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _float_tensors(v)
