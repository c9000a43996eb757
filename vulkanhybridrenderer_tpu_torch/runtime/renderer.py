"""Frame driver (port of ``runtime/renderer.py``, the parts the slice runs).

Owns the device copy of the scene, the render graphs, the previous-frame
matrices, the BVH8, the shadow grid, the shade tables and the SVGF temporal
state.  ``animate`` sets the primitive transforms of the next frames; a
configuration with ``animated=True`` refits the BVH8 (and rebuilds the
shadow grid) every frame, and its graph is kept apart from the static one,
since graphs are keyed on the whole configuration.
``render_frame(sync=True, srgb8=False)``, the reference's signature, runs
the active graph on ``device`` the way ``dispatch`` says (runtime/dispatch.py).
On a CUDA device "fused", the default, runs a (path, config)'s first frame
eagerly, captures the frame function (``RenderGraph.make_frame_fn``) into
one CUDA graph at its second and replays it from then on; "per_pass"
captures one graph per pass, all of a key's at its first frame with
``auto_precompile`` (``precompile_passes``), else at its second.  On the CPU (the tests) both call the frame function directly.
With a ``mesh`` (parallel/mesh.py) the frame is row-sharded across the
mesh's devices, whatever the path: each image pass runs once a shard over
its row slab, with the halo and gather exchanges the pass declares (the
raytraced and rayquery paths need none), the raster runs sort-last, each
shard resolving and shading its band, and the frame is gathered on the
primary, where it is returned; the temporal state stays on the shards between frames.  On
CUDA that frame (``make_sharded_frame_fn``'s passes) is captured as one
device's is, in either mode, each graph spanning the mesh's cards
(runtime/dispatch.py); on a CPU mesh it runs eagerly.  The first frame checks the
binning against its static entry cap (``check_binning``).  A graph is built
once per (path, config), as the reference caches its compiled frame
functions, so switching back with ``set_path`` / ``set_config`` reuses it;
the captured frame is kept for the active (dispatch, path, config) only,
since it holds a whole frame's device buffers: a switch releases it at the
next frame, and switching back captures again.  The temporal state lives at trace
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
    make_temporal_state,
    pack_per_frame_data,
    per_frame_data_from_flat,
    upload_per_frame_data,
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
                 path: str = "hybrid", mesh=None, dispatch: str = "fused",
                 auto_precompile: bool = True, device=None):
        """mesh: optional parallel.mesh.Mesh, the frame over its devices
        (the reference's row-sharded frame); None renders on one device.
        dispatch: "fused" (default) or "per_pass", the reference's modes
        (module docstring); auto_precompile: in "per_pass", capture every
        pass of a new (path, config) at its first frame.  device: where the
        frame runs, "cuda" by default, the mesh's primary with a mesh.  The
        scene is uploaded once; the BVH is built on the host at the first
        frame."""
        if dispatch not in ("fused", "per_pass"):
            raise ValueError(f"dispatch={dispatch!r}: 'fused' or 'per_pass'")
        self.scene = scene
        self.config = config or RenderConfig()
        self.mesh = mesh
        self.dispatch = dispatch
        self.auto_precompile = auto_precompile
        if mesh is None:
            self.device = torch.device("cuda" if device is None else device)
        else:
            from vulkanhybridrenderer_tpu_torch.parallel.mesh import canonical_device

            self.device = mesh.primary
            if device is not None and canonical_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's primary {self.device}")
        # the reference validates this at build time: coverage MSAA's
        # shared-binning raster is single-device
        fwd = self.config.forward
        if (mesh is not None and path == "forward" and fwd.msaa_samples > 1
                and fwd.msaa_mode == "coverage"):
            raise ValueError(
                "forward msaa_mode='coverage' is single-device; use "
                "msaa_mode='supersample' on a mesh"
            )
        self.buffers = scene.buffers.to(self.device)
        self.prim_transform = self.buffers.prim_transform
        self.path_name = path
        self._graphs: dict = {}
        #: the active (dispatch, path, config)'s runtime.dispatch.CapturedFrame
        #: (CUDA only; one at a time, see _captured_frame)
        self._captured = None
        self._binning_checked = False
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
        return make_temporal_state(*self._temporal_dims(), device=self.device)

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

    def _pack_pfd(self):
        """This frame's PerFrameData as pack_per_frame_data's host arrays;
        the current camera becomes the previous view."""
        cam = self.scene.camera
        view = cam.view()
        proj = cam.projection(aspect=self.config.width / self.config.height)
        packed = pack_per_frame_data(
            view, proj, self.scene.light, self.config.width, self.config.height,
            frame_index=self.frame_index, prev_view=self._prev_view,
            prev_proj=self._prev_proj,
        )
        self._prev_view, self._prev_proj = view, proj
        return packed

    def _make_pfd(self) -> PerFrameData:
        return per_frame_data_from_flat(*upload_per_frame_data(*self._pack_pfd(),
                                                               device=self.device))

    def _get_bvh(self):
        """BVH8 over the world triangles, built once on the host and
        uploaded: the host SAH build where the native build is available,
        else, as the reference's (runtime/renderer.py:200-203), the LBVH
        built on the renderer's device; collapsed into the table kind the
        reference's rule picks (runtime/renderer.py:204-232) from
        config.bvh_leaf_max and bvh_dtype.  With leaf_max 0 on a static
        scene and a dtype other than "f32": bf16 leaf-8 rows when bvh_dtype
        is "bf16" or when the f32 leaf-8 table is past
        bvh8.TABLE_BUDGET_BYTES and the bf16 one is not; past it both, the
        f32 leaf-12 rows where they are not, else the leaf-8 ones; else the
        f32 leaf-8 rows.  leaf_max 0 otherwise: build_bvh8_auto.  A leaf_max
        of 8 or 12: those rows, in bf16 where asked."""
        if self._bvh is None:
            from vulkanhybridrenderer_tpu_torch import native_bridge
            from vulkanhybridrenderer_tpu_torch.ops import bvh as bvh_ops
            from vulkanhybridrenderer_tpu_torch.ops import bvh8 as bvh8_ops
            from vulkanhybridrenderer_tpu_torch.ops.geometry import to_world

            world = to_world(self.buffers, self.prim_transform)
            tris = bvh_ops.world_triangles(world.position, self.buffers.tri_vertex)
            if native_bridge.native_available():
                binary = native_bridge.build_sah_host(tris.cpu().numpy())
            else:
                binary = bvh_ops.build(tris, leaf_size=1)
            tris = tris.cpu().numpy()
            lm = self.config.bvh_leaf_max
            dt = self.config.bvh_dtype
            if lm == 0 and dt != "f32" and not self.config.animated:
                b8 = bvh8_ops.build_bvh8_host(binary, tris, leaf_max=8)
                budget = bvh8_ops.TABLE_BUDGET_BYTES
                if dt == "bf16" or (b8.num_rows * 512 > budget and b8.num_rows * 256 <= budget):
                    b = bvh8_ops.table_to_bf16(b8)
                elif b8.num_rows * 512 > budget:
                    b12 = bvh8_ops.build_bvh8_host(binary, tris, leaf_max=12)
                    b = b12 if b12.num_rows * 512 <= budget else b8
                else:
                    b = b8
            elif lm == 0:
                b = bvh8_ops.build_bvh8_auto(binary, tris)
            else:
                b = bvh8_ops.build_bvh8_host(binary, tris, leaf_max=lm)
                if dt == "bf16":
                    b = bvh8_ops.table_to_bf16(b)
            self._bvh = b.to(self.device)
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
        if self.mesh is not None:
            # each shard reads the mesh's replica of the scene, its tables
            # and the BVH8, made at first use and kept while the object
            # lives (a refit BVH8 is copied again)
            res["mesh"] = self.mesh
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

    def check_binning(self, pfd=None) -> None:
        """The reference's host-side check that the binned raster's static
        entry cap (rasterizer_tiled.default_e_cap) holds every tile entry of
        the camera's view and, where the frame rasters the shadow map (a
        Depth Prepass), the light's: raises otherwise, with the reference's
        text.  (The reference checks the light's view on every frame, so its
        first frame raises for a map no pass draws.)  Called once, at the
        first frame (one sync); later frames are guarded on the device,
        where an overflow NaN-poisons the depth (rasterize_scene)."""
        if self.config.raster != "binned":
            return
        from vulkanhybridrenderer_tpu_torch.ops import geometry, rasterizer
        from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as rt
        from vulkanhybridrenderer_tpu_torch.utils.math3d import matmul4

        pfd = pfd if pfd is not None else self._make_pfd()
        world = geometry.to_world(self.buffers, self.prim_transform)
        size = self.config.shadow_map_size
        views = [(matmul4(pfd.camera_proj, pfd.camera_view), self.config.width,
                  self.config.height)]
        if "Depth Prepass" in self.graph.find_execution_order():
            views.append((pfd.directional_light.projview, size, size))
        for vp, w, h in views:
            clip = geometry.to_clip(world.position, vp)
            setup = rasterizer.triangle_setup(clip, self.buffers.tri_vertex, w, h)
            ov = int(rt.bin_triangles(setup, w, h).overflow[0])
            if ov > 0:
                raise RuntimeError(
                    f"binned rasterizer entry overflow at {w}x{h}: "
                    f"{ov} tile entries over the static e_cap — "
                    "triangles would be dropped; raise e_cap "
                    "(ops/rasterizer_tiled.default_e_cap) for this scene"
                )

    def _consts(self) -> dict:
        """The resources a captured frame reads where they lie."""
        res = self._resources(None)
        return {k: v for k, v in res.items()
                if k not in ("pfd", "prim_transform", "temporal_state")}

    def _captured_frame(self, per_pass: bool):
        """This key's CapturedFrame.  Only the active key's is kept: each
        holds its graphs' memory pool, every pass's output buffers and its
        inputs, a frame's worth of device memory, so a viewer's slider,
        which makes a config a value, would otherwise pin a frame a value.
        A new key, or a resource the frame reads in place being replaced (a
        new shadow grid for a turned light), releases the old one first
        (one device sync) and captures anew."""
        from vulkanhybridrenderer_tpu_torch.runtime.dispatch import CapturedFrame

        key = ("per_pass" if per_pass else "fused", self.path_name, self.config)
        consts = self._consts()
        cf = self._captured
        if cf is None or cf.key != key or not cf.matches(consts):
            if cf is not None:
                self._captured = None
                cf.release()
            keep = ("TemporalStateOut",) if self.path.uses_temporal_state else ()
            cf = self._captured = CapturedFrame(
                key, self.graph, RENDER_OUTPUT, keep, per_pass, self.device, consts,
                self.buffers.num_primitives,
                self.temporal_state if self.path.uses_temporal_state else None,
                (self.config.height, self.config.width))
        return cf

    def precompile_passes(self, max_workers: int | None = None) -> dict[str, float]:
        """The reference's precompile_passes: build every pass of the active
        (path, config) for dispatch="per_pass" ahead of its frames.  On a
        CUDA device, or a mesh of them, one eager frame builds the kernels
        and caches, then each pass is captured into its CUDA graph (over a
        mesh one spanning its cards); returns {pass: capture seconds},
        "__trace_s__" (the eager frame) and "__wall_s__" (the whole).  The
        frame index, previous view and temporal state are left as they
        were.  On the CPU nothing is built and every value is 0.0.
        max_workers: accepted for the reference's signature; captures run
        one after another on one stream.  The per-pass graphs become the
        renderer's one captured frame (_captured_frame), in place of
        whatever it held."""
        order = self.graph.find_execution_order()
        if self.device.type != "cuda":
            return {**{n: 0.0 for n in order}, "__trace_s__": 0.0, "__wall_s__": 0.0}
        t0 = time.perf_counter()
        cf = self._captured_frame(per_pass=True)
        prev = (self._prev_view, self._prev_proj)
        cf.load(self._pack_pfd(), self.prim_transform, self.temporal_state)
        self._prev_view, self._prev_proj = prev
        saved = cf.save_state()
        cf.warm()
        torch.cuda.synchronize(self.device)
        trace_s = time.perf_counter() - t0
        seconds = cf.capture()
        cf.restore_state(saved)
        if cf.state is not None:
            self.temporal_state = cf.state
        for d in [self.device, *cf.others]:
            torch.cuda.synchronize(d)
        return {**{n: seconds.get(n, 0.0) for n in order}, "__trace_s__": trace_s,
                "__wall_s__": time.perf_counter() - t0}

    def _frame_fn(self):
        keep = ("TemporalStateOut",) if self.path.uses_temporal_state else ()
        if self.mesh is not None:
            from vulkanhybridrenderer_tpu_torch.parallel.mesh import make_sharded_frame_fn

            return make_sharded_frame_fn(self.graph, self.mesh, self.config.height,
                                         self.config.width, RENDER_OUTPUT, keep=keep)
        return self.graph.make_frame_fn(RENDER_OUTPUT, keep=keep)

    def _run_frame(self, packed) -> dict:
        """One frame's resources out (RENDER_OUTPUT, and TemporalStateOut
        where the path carries state), dispatched as `dispatch` says."""
        if self.device.type != "cuda":
            return self._frame_fn()(self._resources(per_frame_data_from_flat(
                *upload_per_frame_data(*packed, device=self.device))))
        per_pass = self.dispatch == "per_pass"
        cf = self._captured_frame(per_pass)
        if per_pass and self.auto_precompile and not cf.captured:
            self.precompile_passes()
        cf.load(packed, self.prim_transform, self.temporal_state)
        if cf.captured:
            res = cf.replay()
        elif not cf.warmed:
            res = cf.warm()
        else:
            cf.capture()
            res = cf.res
        out = {RENDER_OUTPUT: res[RENDER_OUTPUT].clone()}
        if cf.state is not None:
            out["TemporalStateOut"] = cf.state
        return out

    def render_frame(self, sync: bool = True, srgb8: bool = False):
        """Render one frame; returns the (4, H, W) linear RENDER_OUTPUT on the
        device, or with srgb8=True the (H, W, 4) uint8 sRGB image, a tensor
        of its own (a captured frame's output buffer is copied, since the
        next replay overwrites it).  The work is queued on the device's
        current stream (over a mesh, the captured frame's graphs launch
        there after the other cards' current streams and before them, so
        the frame's time and sync=True cover every device); with sync=True (the
        reference's jax.block_until_ready) it returns once the frame has
        finished there, with sync=False once it is queued.  Both give the
        same frame, and so do both dispatch modes."""
        packed = self._pack_pfd()
        if not self._binning_checked:
            self._binning_checked = True
            self.check_binning(per_frame_data_from_flat(
                *upload_per_frame_data(*packed, device=self.device)))
        cuda = self.device.type == "cuda"
        if cuda:
            self._read_frame_times()
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        else:
            t0 = time.perf_counter()
        res = self._run_frame(packed)
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
        as they were; the previous view becomes the current camera's.  Over
        a mesh the frame runs row-sharded and each image comes back whole,
        on the primary."""
        resources = self._resources(self._make_pfd())
        if self.mesh is None:
            res = self.graph.run(resources)
            return {n: res[n] for n in names}
        from vulkanhybridrenderer_tpu_torch.parallel.mesh import run_sharded

        res = run_sharded(self.graph, self.mesh, resources, self.config.height,
                          self.config.width)
        return {n: self.mesh.whole(res[n]) for n in names}

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
        becomes the current camera's.  Over a mesh each pass runs as in the
        mesh frame and is timed across every device of the mesh."""
        resources = self._resources(self._make_pfd())
        if self.mesh is None:
            timings = self.graph.time_passes(resources, iters=iters)
        else:
            from vulkanhybridrenderer_tpu_torch.parallel.mesh import time_passes_sharded

            timings = time_passes_sharded(self.graph, self.mesh, resources, self.config.height,
                                          self.config.width, iters=iters)
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
