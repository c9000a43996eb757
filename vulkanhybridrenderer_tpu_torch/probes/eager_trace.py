"""Where an eager frame's time goes, on the card: the frame's passes run one
op at a time from Python (``graph.run``, no CUDA graph), as a mesh frame and
``fetch_resources`` run it.

    python3 vulkanhybridrenderer_tpu_torch/probes/eager_trace.py [--root DIR] [--cells 2,3,8]

--root: the checkout whose ``vulkanhybridrenderer_tpu_torch`` is imported
(default: the one holding this file), so that one call can time two commits
with the same script.  Cells (PERF.md section 4, at 1920x1080): 2, the full
hybrid frame on ``sponza_proxy()``; 3, the forward frame with coverage MSAA
4x; 8, the full hybrid frame on the flagship asset ``realglb``.  For each:

- ms/frame of 10 eager frames by CUDA events, and the host's ms to queue
  them (the loop's wall clock before the closing sync);
- a torch.profiler window of 3 eager frames: each pass's host ms (a
  ``record_function`` range around it), the device busy share (the
  kernels' own events over the window), the ops with the most host time
  and the kernels with the most device time, with their calls a frame;
- the alpha peel's alpha tests: calls a frame, pixels each tests, and their
  device ms a frame (each call re-run on its own inputs under the
  profiler, its kernels' events summed: device time whether or not the
  host keeps up);
- the same 10 eager frames again while a second renderer of the cell holds
  its default-dispatch frame (captured CUDA graphs where the checkout has
  them), with the memory the caching allocator holds before and after, and
  once more with Python's garbage collector frozen (gc.freeze), which
  tells whether its passes over the second renderer's objects are the
  cost.
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import sys
import time
from pathlib import Path

WIDTH, HEIGHT = 1920, 1080


def _args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--cells", default="2,3,8")
    return p.parse_args()


def _kernel_us(prof) -> dict:
    """{kernel name: (device us, launches)} of a profile's device events
    (not the device-side copies of the passes' record_function ranges)."""
    out: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and not e.name.startswith("pass: "):
            us, n = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return out


def main() -> int:
    args = _args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("eager_trace: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile, record_function

    from vulkanhybridrenderer_tpu_torch.core import config as cfgmod
    from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT
    from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as rt
    from vulkanhybridrenderer_tpu_torch.runtime import app
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
    from vulkanhybridrenderer_tpu_torch.scene import procedural

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    root = Path(args.root).resolve()
    commit = subprocess.run(["git", "-C", str(root), "log", "-1", "--format=%h"],
                            capture_output=True, text=True).stdout.strip() or root.name
    print(f"eager_trace: package from {root} ({commit}) | torch {torch.__version__} | {smi}")
    dev = torch.device("cuda", 0)
    full = cfgmod.HybridSettings(
        shadow_mode=cfgmod.ShadowMode.RAYTRACED, ao_mode=cfgmod.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=cfgmod.ReflectionMode.RAYTRACED, denoise=True, rt_scale=1)
    full_cfg = cfgmod.RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="brute",
                                   alpha_peel_rounds=4, ao_rays=2, hybrid=full)
    fwd_cfg = cfgmod.RenderConfig(width=WIDTH, height=HEIGHT,
                                  forward=cfgmod.ForwardSettings(msaa_samples=4))
    cells = {"2": (procedural.sponza_proxy, full_cfg, "hybrid"),
             "3": (procedural.sponza_proxy, fwd_cfg, "forward"),
             "8": (lambda: app.load_any_scene("realglb"), full_cfg, "hybrid")}

    def eager_frame(r, ranges=False):
        res = r._resources(r._make_pfd())
        for name in r.graph.find_execution_order():
            p = r.graph.passes[name]
            if ranges:
                with record_function(f"pass: {name}"):
                    produced = p.fn(res)
            else:
                produced = p.fn(res)
            res.update({k: produced[k] for k in p.outputs})
        if r.path.uses_temporal_state:
            r.temporal_state = res["TemporalStateOut"]
        r.frame_index += 1
        return res[RENDER_OUTPUT]

    def timed(r, n=10):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            eager_frame(r)
        end.record()
        host = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n, host

    for cell in args.cells.split(","):
        make_scene, cfg, path = cells[cell]
        scene = make_scene()
        r = Renderer(scene, cfg, path=path, device=dev)
        for _ in range(2):
            eager_frame(r)
        ms, host = timed(r)
        print(f"cell {cell} ({scene.name}, {path}): eager {ms:.3f} ms/frame over 10 frames, "
              f"host {host:.3f} ms/frame to queue them | {smi}")

        frames = 3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(frames):
                eager_frame(r, ranges=True)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        avg = prof.key_averages()
        passes = [e for e in avg if e.key.startswith("pass: ") and e.cpu_time_total > 0]
        ops = [e for e in avg if not e.key.startswith("pass: ")]
        kernels = _kernel_us(prof)
        dev_us = sum(us for us, _ in kernels.values())
        print(f"cell {cell}: profiled window {wall_us / 1e3 / frames:.3f} ms/frame, device "
              f"{dev_us / 1e3 / frames:.3f} ms/frame in {sum(n for _, n in kernels.values()) / frames:g} "
              f"kernels, busy {dev_us / wall_us:.4f}; host ms a frame by pass: " + ", ".join(
                  f"{e.key[6:]} {e.cpu_time_total / 1e3 / frames:.3f}" for e in passes))
        top = sorted(ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
        print(f"cell {cell}: top ops by self host time (ms a frame, calls a frame): " +
              "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / frames:.3f} "
                        f"({e.count / frames:g})" for e in top))
        top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
        print(f"cell {cell}: top kernels by device time (ms a frame, launches a frame): " +
              "; ".join(f"{k[:60]} {us / 1e3 / frames:.3f} ({n / frames:g})"
                        for k, (us, n) in top))

        calls = []
        real = rt.alpha_test

        def recorded(*a, **k):
            calls.append((a, k))
            return real(*a, **k)

        rt.alpha_test = recorded
        try:
            eager_frame(r)
        finally:
            rt.alpha_test = real
        torch.cuda.synchronize()
        if calls:
            ms_each, tested = [], []
            for a, k in calls:
                real(*a, **k)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as one:
                    real(*a, **k)
                    torch.cuda.synchronize()
                ms_each.append(sum(us for us, _ in _kernel_us(one).values()) / 1e3)
                vis = a[1] if len(a) > 1 else k["vis"]
                tested.append(f"{int((vis.tri_id >= 0).sum())}/{vis.tri_id.numel()}")
            print(f"cell {cell}: alpha tests {len(calls)} a frame, {sum(ms_each):.3f} ms of "
                  f"device a frame (each {', '.join(f'{m:.3f}' for m in ms_each)}); covered / "
                  f"all pixels of each test's image {tested} | {smi}")
        del calls

        reserved0 = torch.cuda.memory_reserved(dev)
        other = Renderer(scene, cfg, path=path, device=dev)
        other._bvh, other._shade_tables = r._bvh, r._shade_tables
        for _ in range(3):
            other.render_frame()
        ms2, host2 = timed(r)
        gc.collect()
        gc.freeze()
        try:
            ms3, host3 = timed(r)
        finally:
            gc.unfreeze()
        ms4, _ = timed(r)
        print(f"cell {cell}: eager beside a renderer holding its default-dispatch frame: "
              f"{ms2:.3f} ms/frame, host {host2:.3f}; with gc frozen {ms3:.3f}, host "
              f"{host3:.3f}; unfrozen again {ms4:.3f}; reserved {reserved0 / 2**20:.1f} -> "
              f"{torch.cuda.memory_reserved(dev) / 2**20:.1f} MiB | {smi}")
        del r, other, scene
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
