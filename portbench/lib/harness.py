"""One run of one cell: set up, measure a window, check, print one line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The system under test is the port, ``vulkanhybridrenderer_tpu_torch``,
through its public entry points: ``Renderer(scene, config, path=...,
mesh=...)`` with the default dispatch (one replayed CUDA graph a frame), the
scene's camera set to the traffic's pose, then ``render_frame(sync=False)``,
which returns the linear RENDER_OUTPUT.  At most ``in_flight`` frames are
queued: frame i is submitted once frame i - in_flight has ended on the
device.

Set-up: the benchmark writes or makes the scene, the port loads it and
builds its renderer, and frames run until the frame is captured and replayed
and a few more; set-up ends, and the window starts, at the first timed
frame.  With ``--trace 0`` the window lasts ``--seconds`` seconds and the
line carries the cell's end-to-end metrics; with ``--trace 1`` a profiled
window of the cell's ``trace_frames`` frames gives its per-layer metrics,
after as many frames with the profiler off, which time the host's submit.

In both, the loop keeps ``check.frames`` of its frames, the first drawn
from the seed among its first ``check.within``; once the window has closed
the port is freed and the reference renders the same frames
(``lib/check.py``).  The line's ``correct`` is whether every number the
check compares is within its limit; each number and its limit are printed
on standard error, last, and in the line under ``check``, its last key.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

from portbench.lib import check as check_mod
from portbench.lib import spec as spec_mod
from portbench.lib.fly import Fly, view_forward

FORBIDDEN = ("jax", "jaxlib", "flax", "vulkanhybridrenderer_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of FORBIDDEN, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--intervals", default=None, metavar="PATH",
                   help="also write the window's frame intervals (ms) to PATH as JSON, "
                        "with the frame index of the first (a look at a run's spread)")
    return p.parse_args(argv)


class Run:
    """The program's side of one run: the renderer, the pose of each frame,
    the frame loop and its events."""

    def __init__(self, cell, seed: int, device_count: int, workdir: Path,
                 size=None, scene=None, settings=None, fault=None):
        """size: (width, height) in place of the configuration's; scene and
        settings: entries in place of its scene's and of the cell's render
        settings (the CPU tests at a tiny size); fault: fault(run, out) ->
        out, a break in the timed path (the tests of the check)."""
        import torch

        self.torch = torch
        self.cell, self.seed = cell, seed
        self.port = import_port()
        self.fault = fault
        cfg = dict(cell.config)
        if size is not None:
            cfg["width"], cfg["height"] = size
        if scene is not None:
            cfg["scene"] = {**cfg["scene"], **scene}
        self.config_dict = cfg
        if settings is not None:
            cell = dataclasses.replace(cell, workload={
                **cell.workload, "render_config": {**cell.workload["render_config"], **settings}})
            self.cell = cell
        self.cuda = device_count > 0
        self.devices = ([torch.device("cuda", i) for i in range(cell.chips)] if self.cuda
                        else [torch.device("cpu")])
        made = spec_mod.generator(cfg["scene"]["generator"])(cfg["scene"], workdir)
        self.made = made
        t0 = time.perf_counter()
        scene = port_scene(self.port, made, cfg["scene"])
        rc = spec_mod.render_config(self.port.config, cfg, cell.workload)
        mesh = None
        shards = int(cfg.get("mesh_shards", 1))
        if shards > 1:
            mesh = self.port.mesh.make_mesh(
                self.devices if self.cuda else [torch.device("cpu")] * shards)
        self.renderer = self.port.Renderer(scene, rc, path=cell.workload["path"], mesh=mesh,
                                           device=None if self.cuda else "cpu")
        self.scene_load_s = time.perf_counter() - t0
        self.mesh = mesh
        self.primary = self.renderer.device
        cam = scene.camera
        #: the scene's own camera, where every seed's path starts
        self.start = (np.array(cam.position, np.float32), cam.yaw, cam.pitch,
                      view_forward(cam.view()))
        self.fly = Fly(cell.traffic, seed, *self.start)
        self.in_flight = int(cell.traffic["in_flight"])
        self.first_frames_s = None

    # -- frames -------------------------------------------------------------
    def pose_camera(self) -> None:
        """Set the scene's camera to the next frame's pose."""
        r = self.renderer
        pose = self.fly.pose(r.frame_index)
        cam = r.scene.camera
        cam.position = np.asarray(pose.position, np.float32)
        cam.yaw, cam.pitch = pose.yaw, pose.pitch

    def render(self):
        """Queue the frame; its output."""
        out = self.renderer.render_frame(sync=False)
        if self.fault is not None:
            out = self.fault(self, out)
        return out

    def submit(self):
        self.pose_camera()
        return self.render()

    def sync(self):
        if self.cuda:
            for d in self.devices:
                self.torch.cuda.synchronize(d)

    def event(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record(self.torch.cuda.current_stream(self.primary))
        return ev

    def warm_up(self, frames: int) -> None:
        """Frames until the captured frame has replayed `frames` times: the
        first runs eagerly, the second is captured (runtime/dispatch.py)."""
        t0 = time.perf_counter()
        for _ in range(3):
            self.submit()
            self.sync()
        self.first_frames_s = time.perf_counter() - t0
        for _ in range(frames):
            self.submit()
        self.sync()

    def loop(self, until=None, frames=None, spans=None, sample=None):
        """Frames back to back, at most in_flight queued, until the host
        clock passes `until` or `frames` frames were submitted, and on until
        `sample` (a check.Sample) has its frames.  Returns (start event,
        end events and host ms of each submit of the frames before the
        stop, the window's)."""
        span = spans or _no_span
        start = self.event() if self.cuda else None
        ends, submit_ms = [], []
        k, counted = 0, None
        while True:
            if counted is None and not ((frames is None or k < frames)
                                        and (until is None or time.perf_counter() < until)):
                counted = k
            if counted is not None and (sample is None or sample.done):
                break
            if self.cuda and k >= self.in_flight:
                with span("wait"):
                    ends[k - self.in_flight].synchronize()
            if sample is not None and k == sample.at:
                sample.first = self.renderer.frame_index
            with span("camera"):
                self.pose_camera()
            with span("submit"):
                t0 = time.perf_counter()
                out = self.render()
                submit_ms.append((time.perf_counter() - t0) * 1e3)
            if sample is not None and sample.first is not None and not sample.done:
                sample.outs.append(out)
            if self.cuda:
                ends.append(self.event())
            k += 1
        with span("sync"):
            self.sync()
        return start, ends[:counted], submit_ms[:counted]

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        return max(self.torch.cuda.max_memory_allocated(d) for d in self.devices)


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _no_span(name):
    return _NoSpan()


def import_port():
    """The port's public modules."""
    from vulkanhybridrenderer_tpu_torch.core import config
    from vulkanhybridrenderer_tpu_torch.parallel import mesh
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
    from vulkanhybridrenderer_tpu_torch.scene import gltf

    return types.SimpleNamespace(Renderer=Renderer, config=config, gltf=gltf, mesh=mesh)


def port_scene(port, made: dict, params: dict):
    """The port's host Scene of what a generator made: a GLB file through
    ``gltf.load_scene``, host arrays through ``gltf.build_scene_buffers``."""
    import torch

    g = port.gltf
    if "glb" in made:
        return g.load_scene(made["glb"], atlas_dtype=getattr(
            torch, params.get("atlas_dtype", "float32")))
    a = made["arrays"]
    buffers = g.build_scene_buffers(a["positions"], a["normals"], a["tangents"], a["uv0"],
                                    a["uv1"], a["indices"], a["primitives"], a["images"],
                                    a["srgb"])
    cam = a["camera"]
    return g.Scene(name=a["name"], buffers=buffers, camera=g.Camera(**cam),
                   light=g.make_directional_light(**a["light"]))


def measure(run: Run, seconds: float, trace: bool, setup_t0: float, sample=None):
    """The window: end-to-end numbers (trace off) or the traced window's
    raw readings (trace on), in a context the metric readers take; the
    loop fills `sample` with the frames the check compares."""
    from portbench.lib import window

    ctx = types.SimpleNamespace(cell=run.cell, seed=run.seed, config=run.config_dict,
                                scene_load_s=run.scene_load_s,
                                first_frames_s=run.first_frames_s, cards=len(run.devices),
                                triangles=int(run.renderer.buffers.num_triangles))
    if not trace:
        ctx.setup_s = time.time() - setup_t0
        ctx.first_frame = run.renderer.frame_index
        start, ends, _ = run.loop(until=time.perf_counter() + seconds, sample=sample)
        ctx.frames = len(ends)
        ctx.intervals_ms = window.intervals_ms(0.0, [start.elapsed_time(e) for e in ends])
        return ctx
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.lib import trace as trace_mod

    def span(name):
        return record_function(trace_mod.SPAN_PREFIX + name)

    n = int(run.cell.workload["trace_frames"])
    # the host's time to submit a frame, read with the profiler off: CUPTI
    # instruments every node of a replayed graph and would be read with it
    _, _, ctx.submit_ms = run.loop(frames=n, sample=sample)
    moved0 = dict(run.mesh.moved) if run.mesh is not None else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("window"):
            _, ends, _ = run.loop(frames=n, spans=span)
    ctx.frames = n
    if moved0 is not None:
        ctx.moved_bytes = {k: v - moved0.get(k, 0) for k, v in run.mesh.moved.items()}
    else:
        ctx.moved_bytes = None
    ctx.ops, ctx.spans = trace_mod.from_profiler(prof)
    ctx.window_us = trace_mod.window(ctx.spans, ctx.ops)
    ctx.steady_us = trace_mod.steady(ctx.spans, ctx.ops, ctx.window_us, run.in_flight)
    ctx.devices = [d.index for d in run.devices]
    del prof, torch
    return ctx


def window_sample_at(cell, seed: int) -> int:
    """Where the check's frames start in the first loop after set-up, drawn
    from the seed: within its first ``check.within`` frames."""
    frames = int(cell.workload["check"]["frames"])
    last = int(cell.workload["check"]["within"]) - frames
    return check_mod.sample_at(seed, 1, max(1, last))


def device_info(run: Run, ctx, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.devices[0]),
            "count": len(run.devices), "memory_peak_bytes": int(run.memory_peak())}
    if trace:
        from portbench.lib import trace as trace_mod

        lo, hi = ctx.steady_us
        busy = [trace_mod.busy_us(ctx.ops, d, lo, hi) / 1e6 for d in ctx.devices]
        info["busy_s"] = sum(busy) / len(busy)
        info["window_s"] = (hi - lo) / 1e6
    return info


def breakdown(ctx) -> dict:
    from portbench.lib import trace as trace_mod

    lo, hi = ctx.steady_us
    return {"device_ops": trace_mod.top_ops(ctx.ops),
            "idle_gaps": trace_mod.idle_gaps(ctx.ops, ctx.spans, ctx.devices, lo, hi)}


def read_metrics(entries, ctx) -> dict:
    """Each metric's reader over the context; a reader that finds nothing
    to read returns None, and the metric is left out."""
    out = {}
    for m in entries:
        value = spec_mod.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its own kernels into its package's ``_build``)."""
    base = root / ".portbench_cache"
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(base / sub)


def main(argv, started: float) -> int:
    args = parse(argv)
    root = Path.cwd()
    cache_env(root)
    cell = spec_mod.load_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 3
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        run = Run(cell, args.seed, torch.cuda.device_count(), Path(tmp))
        run.warm_up(int(cell.workload.get("warm_frames", 3)))
        sample = check_mod.Sample(at=window_sample_at(cell, args.seed),
                                  frames=int(cell.workload["check"]["frames"]))
        ctx = measure(run, args.seconds, bool(args.trace), started, sample)
        metrics = read_metrics(cell.per_layer if args.trace else cell.end_to_end, ctx)
        if args.intervals and not args.trace:
            Path(args.intervals).write_text(json.dumps(
                {"first_frame": ctx.first_frame, "intervals_ms": ctx.intervals_ms}))
        device = device_info(run, ctx, bool(args.trace))
        line = {"correct": False, "attempted": int(ctx.frames), "failed": 0,
                "metrics": metrics, "device": device}
        if args.trace:
            line["breakdown"] = breakdown(ctx)
        del ctx
        verdict = check_mod.check(run, sample, torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded forbidden modules {bad}", file=sys.stderr)
        return 4
    print(f"portbench: the reference's check of frames {verdict['first']}-"
          f"{verdict['first'] + sample.frames - 1}: {verdict['reference_s']:.3f} s",
          file=sys.stderr)
    line["correct"] = verdict["correct"]
    line["failed"] = verdict["failed"]
    line["check"] = verdict["numbers"]
    for name, v in verdict["numbers"].items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
