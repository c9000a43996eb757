#!/usr/bin/env python3
"""Drive the PyTorch port (vulkanhybridrenderer_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure raises and exits non-zero:
  1. device   - the GPU's name and nvidia-smi's name / power limit (no CUDA: fail)
  2. build    - nvcc builds K1a (csrc/raster_tile.cu) and K2 (csrc/bvh8_trace.cu)
                for sm_90a, g++ builds the host BVH builder (native/*.cpp)
  3. golden   - the hybrid RT-shadows frame of cornell_box() at 64x64 on the GPU
                against tests/goldens/hybrid_rt_shadows_cornell.npy (RMSE <= 2e-3
                after clamping to [0, 1], the reference's golden tolerance)
  4. kernels  - at the slice's shapes (SponzaProxy, 1920x1080, first frame) each
                kernel against its plain PyTorch version on the same inputs:
                K1a tri id equal on >= 99.99% of pixels and depth / bary exactly
                equal where ids agree (both round every product separately);
                K2 any-hit on the frame's shadow rays: identical hit mask;
                K2 closest-hit on the frame's mirror-reflection rays: tri equal on
                >= 99.99% of rays.  Kernel and plain times by CUDA events.
  5. gpu-cpu  - the SponzaProxy frame at 320x180 on the GPU and on the CPU (plain
                versions): within 1e-4 on >= 99.9% of pixels
  6. main     - the slice: SponzaProxy 1920x1080, HybridSettings(), alpha off;
                2 warm-up + 10 timed frames (CUDA events), finite output, launch
                counters of K1a and K2 reset before and read after the timed
                frames (each must rise by >= 1 per frame), per-pass ms, share of
                shadowed pixels
Then one JSON line with the kernels, nvidia-smi's line, and the status line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

WIDTH, HEIGHT = 1920, 1080
GOLDEN = Path(__file__).resolve().parent / "tests" / "goldens" / "hybrid_rt_shadows_cornell.npy"


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _max_abs(d) -> float:
    return float(d.abs().max()) if d.numel() else 0.0


def _cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() over `iters` runs, by CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke test needs a CUDA GPU", file=sys.stderr)
        return 1

    from vulkanhybridrenderer_tpu_torch import native_bridge
    from vulkanhybridrenderer_tpu_torch.core.config import HybridSettings, RenderConfig
    from vulkanhybridrenderer_tpu_torch.models import hybrid as hybrid_path
    from vulkanhybridrenderer_tpu_torch.ops import raygen, rasterizer_tiled, traverse
    from vulkanhybridrenderer_tpu_torch.ops.rasterizer import triangle_setup
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
    from vulkanhybridrenderer_tpu_torch.scene import procedural
    from vulkanhybridrenderer_tpu_torch.utils.build import build_log
    from vulkanhybridrenderer_tpu_torch.utils.math3d import normalize, reflect

    # ---- 1. device -------------------------------------------------------------
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _phase("device", t0)

    # ---- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    rasterizer_tiled.load_kernel()
    traverse.load_kernel()
    native_bridge.load()
    for src in ("raster_tile.cu", "bvh8_trace.cu"):
        for line in build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")
    _phase("build", t0)

    # ---- 3. golden ---------------------------------------------------------------
    t0 = time.perf_counter()
    r = Renderer(procedural.cornell_box(),
                 RenderConfig(width=64, height=64, alpha_raster="off"), device=dev)
    img = r.render_frame().cpu().numpy()
    golden = np.load(GOLDEN).astype(np.float32)
    err = float(np.sqrt(np.mean((np.clip(img, 0, 1) - np.clip(golden, 0, 1)) ** 2)))
    print(f"golden cornell 64x64 RMSE {err:.6f} (limit 2e-3)")
    _check(np.isfinite(img).all() and err <= 2e-3, f"golden RMSE {err}")
    _phase("golden", t0)

    # ---- 4. kernels against their plain versions at the slice's shapes -----------
    t0 = time.perf_counter()
    scene = procedural.sponza_proxy()
    slice_cfg = RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="off")
    r = Renderer(scene, slice_cfg, device=dev)
    res = r.fetch_resources("pfd", "Clip", "BVH", hybrid_path.DEPTH, hybrid_path.NORMALS)
    pfd, clip, bvh = res["pfd"], res["Clip"], res["BVH"]
    depth, normals = res[hybrid_path.DEPTH], res[hybrid_path.NORMALS]
    print(f"scene {scene.name}: {scene.buffers.num_triangles} triangles, "
          f"BVH8 {bvh.num_rows} rows, depth bound {bvh.depth}")

    setup = triangle_setup(clip, r.buffers.tri_vertex, WIDTH, HEIGHT)
    bins = rasterizer_tiled.bin_triangles(setup, WIDTH, HEIGHT)
    vk = rasterizer_tiled.raster_tiles(setup.planes, bins, WIDTH, HEIGHT)
    vp = rasterizer_tiled.raster_tiles_plain(setup.planes, bins, WIDTH, HEIGHT)
    same = vk.tri_id == vp.tri_id
    k1_share = float(same.float().mean())
    k1_err = max(_max_abs((vk.depth - vp.depth)[same]),
                 _max_abs((vk.bary - vp.bary)[same]))
    k1_ms = _cuda_ms(lambda: rasterizer_tiled.raster_tiles(setup.planes, bins, WIDTH, HEIGHT), 20)
    k1_plain_ms = _cuda_ms(
        lambda: rasterizer_tiled.raster_tiles_plain(setup.planes, bins, WIDTH, HEIGHT), 2)
    print(f"K1a raster_tile: {bins.entry_tri.shape[0]} entries over "
          f"{bins.ntx * bins.nty} tiles; tri id equal on {k1_share:.6f} of pixels, "
          f"max |depth/bary diff| where equal {k1_err:.3g}; "
          f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")
    _check(k1_share >= 0.9999, f"K1a tri id agreement {k1_share}")
    _check(k1_err == 0.0, f"K1a depth/bary differ by {k1_err} where ids agree")

    hs = HybridSettings()
    origin, direction, tmax = raygen.shadow_rays(pfd, depth, normals, hs)
    tmin = torch.full_like(tmax, raygen.SHADOW_TMIN)
    steps = traverse.default_max_steps(bvh)
    ak = traverse.trace(bvh, origin, direction, tmin, tmax, anyhit=True)
    ap = traverse.trace_plain(bvh.rows, bvh.depth, origin, direction, tmin, tmax, True, steps)
    k2_err = float((ak.hit != ap.hit).float().max())
    live = int((tmax >= 0).sum())
    k2_ms = _cuda_ms(lambda: traverse.trace(bvh, origin, direction, tmin, tmax, anyhit=True), 10)
    k2_plain_ms = _cuda_ms(lambda: traverse.trace_plain(
        bvh.rows, bvh.depth, origin, direction, tmin, tmax, True, steps), 1)
    print(f"K2 any-hit bvh8_trace: {origin.shape[0]} shadow rays ({live} live), "
          f"hits {int(ak.hit.sum())}, mismatched hit flags "
          f"{int((ak.hit != ap.hit).sum())}; kernel {k2_ms:.4f} ms, "
          f"plain {k2_plain_ms:.4f} ms")
    _check(k2_err == 0.0, "K2 any-hit hit masks differ")

    p_world, n, sky = raygen.surface(pfd, depth, normals)
    i_dir = normalize(p_world - pfd.camera_position).reshape(-1, 3)
    r_dir = reflect(i_dir, n.reshape(-1, 3)).contiguous()
    r_tmax = torch.where(sky.reshape(-1), -1.0, raygen.SHADOW_TMAX)
    ck = traverse.trace(bvh, origin, r_dir, tmin, r_tmax, anyhit=False)
    cp = traverse.trace_plain(bvh.rows, bvh.depth, origin, r_dir, tmin, r_tmax, False, steps)
    c_same = ck.tri == cp.tri
    c_share = float(c_same.float().mean())
    c_err = _max_abs((ck.t - cp.t)[c_same & ck.hit])
    ck_ms = _cuda_ms(lambda: traverse.trace(bvh, origin, r_dir, tmin, r_tmax, anyhit=False), 10)
    cp_ms = _cuda_ms(lambda: traverse.trace_plain(
        bvh.rows, bvh.depth, origin, r_dir, tmin, r_tmax, False, steps), 1)
    print(f"K2 closest-hit bvh8_trace: {origin.shape[0]} reflection rays, hits "
          f"{int(ck.hit.sum())}, tri equal on {c_share:.6f}, max |t diff| where equal "
          f"{c_err:.3g}; kernel {ck_ms:.4f} ms, plain {cp_ms:.4f} ms")
    _check(c_share >= 0.9999, f"K2 closest-hit tri agreement {c_share}")
    del r, res, setup, bins, vk, vp, ak, ap, ck, cp
    _phase("kernels", t0)

    # ---- 5. GPU against CPU ------------------------------------------------------
    t0 = time.perf_counter()
    small = RenderConfig(width=320, height=180, alpha_raster="off")
    g = Renderer(scene, small, device=dev).render_frame().cpu()
    c = Renderer(scene, small, device="cpu").render_frame()
    close = ((g - c).abs().amax(dim=0) <= 1e-4).float().mean().item()
    print(f"gpu vs cpu 320x180: {close:.6f} of pixels within 1e-4, "
          f"max |diff| {float((g - c).abs().max()):.3g}")
    _check(bool(torch.isfinite(g).all()) and close >= 0.999, f"gpu/cpu agreement {close}")
    _phase("gpu-cpu", t0)

    # ---- 6. main path --------------------------------------------------------------
    t0 = time.perf_counter()
    r = Renderer(scene, slice_cfg, device=dev)
    for _ in range(2):
        frame = r.render_frame()
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(frame).all()), "warm-up frame not finite")
    frames = 10
    rasterizer_tiled.raster_tiles.launches = 0
    traverse.trace.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        frame = r.render_frame()
    end.record()
    torch.cuda.synchronize()
    launches = {"raster_tile": rasterizer_tiled.raster_tiles.launches,
                "bvh8_trace": traverse.trace.launches}
    ms_frame = start.elapsed_time(end) / frames
    _check(tuple(frame.shape) == (4, HEIGHT, WIDTH), f"frame shape {tuple(frame.shape)}")
    _check(bool(torch.isfinite(frame).all()), "main-path frame not finite")
    for name, count in launches.items():
        _check(count >= frames, f"{name} launched {count} times in {frames} frames")
    passes = r.time_passes(iters=5)
    shadow = r.fetch_resources(hybrid_path.RT_SHADOW_AO)[hybrid_path.RT_SHADOW_AO][0]
    shadowed = float((shadow == 0.0).float().mean())
    print(f"main path {scene.name} {WIDTH}x{HEIGHT} RT shadows: {ms_frame:.3f} ms/frame "
          f"over {frames} frames | launches {launches} | shadowed share {shadowed:.4f}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    print(f"card: {smi}")
    _phase("main", t0)

    print(json.dumps({"kernels": [
        {"name": "raster_tile (K1a)", "route": "cuda",
         "source": "vulkanhybridrenderer_tpu_torch/csrc/raster_tile.cu",
         "replaces": "vulkanhybridrenderer_tpu/ops/rasterizer_tiled.py:567",
         "launches": launches["raster_tile"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "bvh8_trace any-hit (K2)", "route": "cuda",
         "source": "vulkanhybridrenderer_tpu_torch/csrc/bvh8_trace.cu",
         "replaces": "vulkanhybridrenderer_tpu/ops/traverse.py:135",
         "launches": launches["bvh8_trace"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
