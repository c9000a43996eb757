"""Cells 9 and 11 (PERF.md section 4) of one checkout on the card: the two
frames whose passes the static sizing of the brute raster and the shadow
grid changed.

    python3 vulkanhybridrenderer_tpu_torch/probes/static_turns.py [--root DIR]

--root: the checkout whose ``vulkanhybridrenderer_tpu_torch`` is imported
(default: the one holding this file), so that one call can time two
commits with the same script, in turns (parent, change, change, parent).
At 1920x1080:

- cell 9, the raster-mode hybrid with ``raster="brute"`` on
  ``cornell_box()`` (its 4096^2 brute prepass included); cell 11,
  ``pica_proxy()`` animated (``animate_pica(scene, i / 60)`` before frame
  i), the full hybrid configuration with ``shadow_accel="grid"``;
- each cell's ms/frame over 10 frames of the default dispatch ("fused")
  after 2 warm-up frames, by CUDA events, the graphs a frame where the
  checkout reports them, and the device ms/frame and busy share of a
  torch.profiler window of 5 frames (the kernels' own events over the
  window's wall time);
- alone, eagerly, 5 runs each by CUDA events: cell 9's brute raster of its
  G-buffer (``rasterizer.rasterize``) and its prepass
  (``shadowmap.render_shadow_map``), and cell 11's grid rebuild at the
  load-time resolution (``shadowgrid.build_shadow_grid``).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

WIDTH, HEIGHT = 1920, 1080


def _args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    return p.parse_args()


def main() -> int:
    args = _args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("static_turns: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from vulkanhybridrenderer_tpu_torch.core import config as cfgmod
    from vulkanhybridrenderer_tpu_torch.ops import bvh, rasterizer, shadowgrid, shadowmap
    from vulkanhybridrenderer_tpu_torch.ops.geometry import to_world
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
    from vulkanhybridrenderer_tpu_torch.scene import procedural

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    label = f"static_turns {root.name}"

    def events_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def frames(r, step):
        clock = iter(range(1 << 30))

        def one():
            step(r, next(clock))
            r.render_frame(sync=False)

        for _ in range(2):
            one()
        ms = events_ms(one, 10)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                one()
            torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1e3
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type.name == "CUDA") / 1e3
        captured = getattr(r, "_captured", None)
        graphs = getattr(captured, "n_graphs", "?")
        return (f"fused {ms:.3f} ms/frame ({graphs} graph(s) a frame), device "
                f"{busy / 5:.3f} ms/frame, busy {busy / window:.4f}")

    hs = cfgmod.HybridSettings
    raster = hs(shadow_mode=cfgmod.ShadowMode.RASTERIZED,
                ao_mode=cfgmod.AmbientOcclusionMode.SSAO)
    cornell = procedural.cornell_box()
    cfg9 = cfgmod.RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="off", raster="brute",
                               hybrid=raster)
    r = Renderer(cornell, cfg9, device=dev)
    line9 = frames(r, lambda rr, f: None)
    res = r.fetch_resources("Clip", "LightClip")
    setup = rasterizer.triangle_setup(res["Clip"], r.buffers.tri_vertex, WIDTH, HEIGHT)
    g_ms = events_ms(lambda: rasterizer.rasterize(setup, WIDTH, HEIGHT), 5)
    p_ms = events_ms(lambda: shadowmap.render_shadow_map(
        res["LightClip"], r.buffers.tri_vertex, cfg9.shadow_map_size, chunk=256), 5)
    print(f"{label} cell 9: {line9}; alone: brute G-buffer raster {g_ms:.3f} ms, brute "
          f"prepass {cfg9.shadow_map_size}^2 {p_ms:.3f} ms | card: {smi}", flush=True)
    del r, res, setup
    torch.cuda.empty_cache()

    full = hs(shadow_mode=cfgmod.ShadowMode.RAYTRACED,
              ao_mode=cfgmod.AmbientOcclusionMode.RAYTRACED,
              reflection_mode=cfgmod.ReflectionMode.RAYTRACED, denoise=True)
    pica = procedural.pica_proxy()
    cfg11 = cfgmod.RenderConfig(width=WIDTH, height=HEIGHT, animated=True, shadow_accel="grid",
                                hybrid=full)
    r = Renderer(pica, cfg11, device=dev)
    line11 = frames(r, lambda rr, f: rr.animate(procedural.animate_pica(pica, f / 60.0)))
    r.animate(procedural.animate_pica(pica, 0.5))
    world = to_world(r.buffers, r.prim_transform)
    tris = bvh.world_triangles(world.position, r.buffers.tri_vertex)
    light = torch.tensor(pica.light.direction[:3], dtype=torch.float32, device=dev)
    grid = r._get_shadow_grid().grid
    b_ms = events_ms(lambda: shadowgrid.build_shadow_grid(tris, light, grid=grid), 5)
    print(f"{label} cell 11: {line11}; alone: grid rebuild ({grid}x{grid}) {b_ms:.3f} ms | "
          f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
