"""The frame over a mesh of one checkout on the card, beside one card's
frame: main path 8 (the full hybrid, ``chip_smoke.py``'s configuration) and
cell 4 (the raster mode: rasterized shadows, SSAO) on realglb at 1920x1080.

    python3 vulkanhybridrenderer_tpu_torch/probes/mesh_turns.py [--root DIR]
        [--mesh virtual|cards|both] [--frames N]

--root: the checkout whose ``vulkanhybridrenderer_tpu_torch`` is imported
(default: the one holding this file), so that one call can time two
commits with the same script, in turns (parent, change, change, parent).
--mesh: a virtual mesh of 4 shards on card 0, ``make_mesh()`` over every
card of the machine (two or more), or both (the default: the virtual mesh
first).  For each configuration:

- one card's frame: ms/frame over 10 frames of the default dispatch after 2
  warm-up frames, by CUDA events;
- each mesh frame: ms/frame over `--frames` frames (default 5) after 2
  warm-up frames, by CUDA events on the primary's stream (render_frame
  makes it wait for every device of the mesh), and the host's ms/frame to
  queue them (render_frame(sync=False) from the first call to the last
  return): where the two agree, the host sets the frame's pace;
- then a torch.profiler window of one mesh frame: the device operations
  (kernels and copies) it ran on every device, and their device ms (their
  own events, summed over the devices) over the window's wall ms, the busy
  share.

The last line of each configuration is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

WIDTH, HEIGHT = 1920, 1080


def _args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--mesh", choices=("virtual", "cards", "both"), default="both")
    p.add_argument("--frames", type=int, default=5)
    return p.parse_args()


def main() -> int:
    args = _args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("mesh_turns: needs a CUDA card", file=sys.stderr)
        return 1
    from vulkanhybridrenderer_tpu_torch.core import config as cfgmod
    from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh
    from vulkanhybridrenderer_tpu_torch.runtime import app
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    meshes = []
    if args.mesh in ("virtual", "both"):
        meshes.append(("virtual 4", lambda: pmesh.make_mesh([dev] * 4)))
    if args.mesh in ("cards", "both"):
        if torch.cuda.device_count() < 2:
            print(f"mesh_turns: --mesh {args.mesh} needs two cards or more", file=sys.stderr)
            return 1
        meshes.append((f"cards {torch.cuda.device_count()}", pmesh.make_mesh))

    def sync_all():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    def frames(r, n):
        """(device ms/frame, host ms/frame) of n frames after 2 warm-up."""
        for _ in range(2):
            r.render_frame()
        sync_all()
        stream = torch.cuda.current_stream(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        t0 = time.perf_counter()
        for _ in range(n):
            r.render_frame(sync=False)
        host = (time.perf_counter() - t0) * 1e3 / n
        end.record(stream)
        sync_all()
        return start.elapsed_time(end) / n, host

    def traced(r):
        """(device operations, their device ms, wall ms) of one frame."""
        sync_all()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r.render_frame(sync=False)
            sync_all()
            wall = (time.perf_counter() - t0) * 1e3
        ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
        return len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e3, wall

    full = cfgmod.HybridSettings(
        shadow_mode=cfgmod.ShadowMode.RAYTRACED, ao_mode=cfgmod.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=cfgmod.ReflectionMode.RAYTRACED, denoise=True, rt_scale=1)
    raster = cfgmod.HybridSettings(shadow_mode=cfgmod.ShadowMode.RASTERIZED,
                                   ao_mode=cfgmod.AmbientOcclusionMode.SSAO)
    configs = {
        "path 8": cfgmod.RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="brute",
                                      alpha_peel_rounds=4, ao_rays=2, hybrid=full),
        "cell 4": cfgmod.RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="off",
                                      hybrid=raster),
    }
    scene = app.load_any_scene("realglb")
    label = f"mesh_turns {root.name}"
    for name, cfg in configs.items():
        r = Renderer(scene, cfg, device=dev)
        out = {"tree": root.name, "config": name, "card": smi,
               "single_ms": frames(r, 10)[0]}
        del r
        for mesh_name, make in meshes:
            r = Renderer(scene, cfg, mesh=make())
            ms, host = frames(r, args.frames)
            ops, busy, wall = traced(r)
            out[mesh_name] = {"ms": ms, "host_ms": host, "device_ops": ops,
                              "device_ms": busy, "traced_ms": wall}
            print(f"{label} {name} over a {mesh_name} mesh: {ms:.3f} ms/frame on the device "
                  f"clock, host {host:.3f} ms/frame to queue ({args.frames} frames); one "
                  f"traced frame: {ops} device operations, {busy:.3f} device ms in {wall:.3f} ms "
                  f"(busy {busy / wall:.4f}) | card: {smi}", flush=True)
            del r
        torch.cuda.empty_cache()
        print(f"{label} {name}: one card {out['single_ms']:.3f} ms/frame (10 frames)",
              flush=True)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
