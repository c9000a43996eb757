"""The frame over a mesh of one checkout on the card, captured and eager,
beside one card's frame: main path 8 (the full hybrid, ``chip_smoke.py``'s
configuration) and cell 4 (the raster mode: rasterized shadows, SSAO) on
realglb at 1920x1080.

    python3 vulkanhybridrenderer_tpu_torch/probes/mesh_turns.py [--root DIR]
        [--mesh virtual|cards|both] [--frames N]

--root: the checkout whose ``vulkanhybridrenderer_tpu_torch`` is imported
(default: the one holding this file), so that one call can time two
commits with the same script, in turns (parent, change, change, parent).
--mesh: a virtual mesh of 4 shards on card 0, ``make_mesh()`` over every
card of the machine (two or more), or both (the default: the virtual mesh
first).  For each configuration and mesh, in turns (one card, eager,
captured, captured, eager, one card):

- one card's frame: ms/frame over 10 frames of the default dispatch
  (fused: one CUDA graph a frame) after 2 warm-up frames, by CUDA events;
- the eager mesh frame (the mesh frame function, run_sharded, from Python
  every frame): ms/frame over `--frames` frames (default 5) after 2
  warm-up frames, by CUDA events on the primary's stream, which waits for
  every card's, and the host's ms/frame to queue them: where the two
  agree, the host sets the frame's pace;
- the captured mesh frame (``Renderer(mesh=)``'s default dispatch: one
  CUDA graph a frame spanning the mesh's cards): the same over 10 frames,
  its graphs a frame and capture seconds;
- then a torch.profiler window of one eager mesh frame and one of 3
  replayed frames: the device operations (kernels and copies) a frame,
  their device ms (their own events, summed over the devices) over the
  window's wall ms, and over the replayed frames each card's busy share:
  the union of its kernels' and copies' device intervals over the window's
  wall ms (how far the cards overlap).

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


def _union_ms(spans) -> float:
    """The length of the union of (start, end) microsecond spans, in ms."""
    total, reach = 0.0, None
    for a, b in sorted(spans):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total / 1e3


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
    from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT
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

    def eager_frame(r):
        """One eager mesh frame of r, advancing it as render_frame does;
        the primary's stream then waits for every card's."""
        res = r._frame_fn()(r._resources(r._make_pfd()))
        if r.path.uses_temporal_state:
            r.temporal_state = res["TemporalStateOut"]
        r.frame_index += 1
        main = torch.cuda.current_stream(dev)
        for d in r.mesh.distinct()[1:]:
            main.wait_stream(torch.cuda.current_stream(d))
        return res[RENDER_OUTPUT]

    def frames(r, n, eager=False):
        """(device ms/frame, host ms/frame) of n frames after 2 warm-up."""
        run = (lambda: eager_frame(r)) if eager else (lambda: r.render_frame(sync=False))
        for _ in range(2):
            run()
        sync_all()
        stream = torch.cuda.current_stream(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        host = (time.perf_counter() - t0) * 1e3 / n
        end.record(stream)
        sync_all()
        return start.elapsed_time(end) / n, host

    def traced(run, n=1):
        """(device operations a frame, their device ms, wall ms, {card: busy
        share}) of n frames."""
        sync_all()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                run()
            sync_all()
            wall = (time.perf_counter() - t0) * 1e3
        ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
        by_card: dict = {}
        for e in ops:
            by_card.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
        busy = {f"cuda:{d}": _union_ms(spans) / wall for d, spans in sorted(by_card.items())}
        return (len(ops) / n, sum(e.time_range.elapsed_us() for e in ops) / 1e3, wall, busy)

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
        one = Renderer(scene, cfg, device=dev)
        out = {"tree": root.name, "config": name, "card": smi, "single_ms": []}
        for mesh_name, make in meshes:
            eager = Renderer(scene, cfg, mesh=make())
            cap = Renderer(scene, cfg, mesh=make())
            for r in (eager, cap):
                r._bvh = one._get_bvh()  # one host build, read in place on the primary
            got = {"eager": [], "captured": []}
            for which in ("one", "eager", "captured", "captured", "eager", "one"):
                if which == "one":
                    out["single_ms"].append(frames(one, 10)[0])
                else:
                    got[which].append(frames(eager, args.frames, eager=True)
                                      if which == "eager" else frames(cap, 10))
            e_ops, e_dev, e_wall, e_busy = traced(lambda: eager_frame(eager))
            c_ops, c_dev, c_wall, c_busy = traced(lambda: cap.render_frame(sync=False), n=3)
            cf = cap._captured
            out[mesh_name] = {
                "eager_ms": [x[0] for x in got["eager"]],
                "eager_host_ms": [x[1] for x in got["eager"]],
                "captured_ms": [x[0] for x in got["captured"]],
                "captured_host_ms": [x[1] for x in got["captured"]],
                "graphs": cf.n_graphs, "capture_s": sum(cf.capture_s.values()),
                "eager_device_ops": e_ops, "eager_device_ms": e_dev, "eager_traced_ms": e_wall,
                "captured_device_ops": c_ops, "captured_device_ms": c_dev / 3,
                "captured_traced_ms": c_wall / 3, "captured_busy": c_busy,
                "eager_busy": e_busy}
            m = out[mesh_name]
            print(f"{label} {name} over a {mesh_name} mesh, in turns (one card, eager, captured, "
                  f"captured, eager, one card): eager {m['eager_ms'][0]:.3f} / "
                  f"{m['eager_ms'][1]:.3f} ms/frame on the device clock (host "
                  f"{m['eager_host_ms'][0]:.3f} / {m['eager_host_ms'][1]:.3f} to queue, "
                  f"{args.frames} frames); captured {m['captured_ms'][0]:.3f} / "
                  f"{m['captured_ms'][1]:.3f} (host {m['captured_host_ms'][0]:.3f} / "
                  f"{m['captured_host_ms'][1]:.3f}, 10 frames; {cf.n_graphs} graph(s) a frame, "
                  f"captured in {m['capture_s']:.3f} s); one card {out['single_ms'][-2]:.3f} / "
                  f"{out['single_ms'][-1]:.3f} | card: {smi}", flush=True)
            print(f"{label} {name} over a {mesh_name} mesh, traced: eager frame {e_ops:.0f} "
                  f"device operations, {e_dev:.3f} device ms in {e_wall:.3f} ms; replayed "
                  f"frame {c_ops:.0f} device operations, {c_dev / 3:.3f} device ms in "
                  f"{c_wall / 3:.3f} ms; each card's busy share over the replayed frames "
                  + ", ".join(f"{d} {b:.4f}" for d, b in c_busy.items())
                  + " (eager: " + ", ".join(f"{d} {b:.4f}" for d, b in e_busy.items())
                  + f") | card: {smi}", flush=True)
            del eager, cap
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
        del one
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
