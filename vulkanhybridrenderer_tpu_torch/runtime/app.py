"""Host application shell (port of ``runtime/app.py``; the reference's
main.cpp + user_interface.cpp, headless).

A CLI driving the renderer's capabilities:

  * scene loading: a .glb / .gltf file, ``realglb`` (the sponza-class GLB
    that ``scene/sample_asset.py`` writes into the package's ignored
    ``_build/`` directory on first use) or a procedural scene; ``--animate
    --scene pica`` moves pica's boxes every frame (BVH8 refit)
  * render-path selection and per-path settings (the ImGui menus,
    user_interface.cpp:100-159) through flags
  * a frame loop with scripted camera motion (WASD equivalent)
  * the per-pass performance table (render_graph.cpp:203-220)
  * a debug dump of any named graph resource (user_interface.cpp:129-150)
  * checkpoint save / restore of camera, path, config and temporal state

Run:  python -m vulkanhybridrenderer_tpu_torch.runtime.app --scene realglb
      --path hybrid --frames 60 --out out.png --stats [--device cpu]

Frames run on CUDA unless ``--device cpu`` is given; without a GPU the CLI
stops with an error instead of falling back.
"""
from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.core import config as cfgmod
from vulkanhybridrenderer_tpu_torch.core.config import (
    AmbientOcclusionMode,
    ForwardSettings,
    HybridSettings,
    RaytracedSettings,
    ReflectionMode,
    RenderConfig,
    ShadowMode,
    SSAOSettings,
    SSRSettings,
)
from vulkanhybridrenderer_tpu_torch.core.types import TemporalState
from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
from vulkanhybridrenderer_tpu_torch.scene import gltf, procedural, sample_asset
from vulkanhybridrenderer_tpu_torch.utils.build import BUILD_DIR
from vulkanhybridrenderer_tpu_torch.utils.image import save_png

PROCEDURAL_SCENES = {
    "cornell": procedural.cornell_box,
    "checker": procedural.checker_quad,
    "sponza": procedural.sponza_proxy,
    "bistro": procedural.bistro_proxy,
    "pica": procedural.pica_proxy,
}
#: the flagship asset bench.py calls "realglb"
REALGLB_PATH = BUILD_DIR / "sponza_class.glb"


def load_any_scene(name: str) -> gltf.Scene:
    """A procedural scene by name, ``realglb``, or a .glb / .gltf path."""
    if name in PROCEDURAL_SCENES:
        return PROCEDURAL_SCENES[name]()
    if name == "realglb":
        if not REALGLB_PATH.exists():
            REALGLB_PATH.parent.mkdir(parents=True, exist_ok=True)
            tmp = REALGLB_PATH.with_suffix(".tmp")
            sample_asset.build_sponza_class_glb(tmp)
            tmp.replace(REALGLB_PATH)
        return gltf.load_scene(REALGLB_PATH)
    return gltf.load_scene(name)


def config_from_args(args) -> RenderConfig:
    hybrid = HybridSettings(
        shadow_mode=ShadowMode[args.shadows.upper()],
        ao_mode=AmbientOcclusionMode[args.ao.upper()],
        reflection_mode=ReflectionMode[args.reflections.upper()],
        denoise=args.denoise,
        ssao=SSAOSettings(radius=args.ssao_radius),
        ssr=SSRSettings(),
    )
    return RenderConfig(
        width=args.width,
        height=args.height,
        shadow_map_size=args.shadow_map_size,
        animated=args.animate,
        raster=args.raster,
        hybrid=hybrid,
        forward=ForwardSettings(msaa_samples=args.msaa),
        raytraced=RaytracedSettings(test_alpha=args.test_alpha),
    )


def _config_from_dict(d: dict) -> RenderConfig:
    """Rebuild a RenderConfig from dataclasses.asdict's output, nested
    settings and enums included."""

    def build(cls, values):
        kw = {}
        for f in dataclasses.fields(cls):
            v = values[f.name]
            ftype = getattr(cfgmod, f.type, None) if isinstance(f.type, str) else f.type
            if dataclasses.is_dataclass(ftype):
                v = build(ftype, v)
            elif isinstance(ftype, type) and issubclass(ftype, enum.Enum):
                v = ftype(v)
            kw[f.name] = v
        return cls(**kw)

    return build(RenderConfig, d)


def save_checkpoint(path, renderer: Renderer) -> None:
    """Persist camera, path, config, frame index and the SVGF temporal state
    (the reference has no checkpointing; its only cross-frame state is the
    SVGF history)."""
    cam = renderer.scene.camera
    state = {
        "camera": {
            "yfov": cam.yfov,
            "znear": cam.znear,
            "aspect": cam.aspect,
            "yaw": cam.yaw,
            "pitch": cam.pitch,
            "roll": cam.roll,
            "position": np.asarray(cam.position).tolist(),
        },
        "path": renderer.path_name,
        "config": dataclasses.asdict(renderer.config),
        "frame_index": renderer.frame_index,
    }
    ts = renderer.temporal_state
    np.savez(
        path,
        meta=json.dumps(state, default=float),
        **{f.name: getattr(ts, f.name).cpu().numpy() for f in dataclasses.fields(ts)},
    )


def load_checkpoint(path, renderer: Renderer) -> None:
    """Restore what save_checkpoint wrote; the temporal state lands on the
    renderer's device."""
    with np.load(path, allow_pickle=False) as data:
        state = json.loads(str(data["meta"]))
        history = {f.name: torch.from_numpy(np.array(data[f.name])).to(renderer.device)
                   for f in dataclasses.fields(TemporalState)}
    cam = renderer.scene.camera
    for k, v in state["camera"].items():
        setattr(cam, k, np.asarray(v, np.float32) if k == "position" else v)
    renderer.set_path(state["path"])
    renderer.set_config(_config_from_dict(state["config"]))
    renderer.frame_index = int(state["frame_index"])
    renderer.temporal_state = TemporalState(**history)


def run_script(renderer: Renderer, script: str):
    """Scripted interactive driving: the headless analogue of the
    reference's ImGui loop switching render paths and settings mid-run
    (user_interface.cpp:100-126, renderer.cpp:159-181).  A graph is kept per
    (path, config), so switching back to a mode reuses it.

    Commands (semicolon-separated):
      frames N                         render N frames
      path forward|hybrid|raytraced|rayquery
      set shadows|ao|reflections|denoise|msaa|test_alpha=VALUE ...
      camera w|a|s|d                   one fly-camera step (1/60 s)

    Returns the last rendered frame (on the renderer's device).
    """
    out = None
    for raw in script.split(";"):
        cmd = raw.strip().split()
        if not cmd:
            continue
        op = cmd[0]
        if op == "frames":
            for _ in range(int(cmd[1])):
                out = renderer.render_frame()
        elif op == "path":
            renderer.set_path(cmd[1])
        elif op == "camera":
            renderer.update_camera(1.0 / 60.0, keys=set(cmd[1:]))
        elif op == "set":
            cfg = renderer.config
            hybrid, forward, raytraced = cfg.hybrid, cfg.forward, cfg.raytraced
            for kv in cmd[1:]:
                k, v = kv.split("=")
                if k == "shadows":
                    hybrid = dataclasses.replace(hybrid, shadow_mode=ShadowMode[v.upper()])
                elif k == "ao":
                    hybrid = dataclasses.replace(
                        hybrid, ao_mode=AmbientOcclusionMode[v.upper()])
                elif k == "reflections":
                    hybrid = dataclasses.replace(
                        hybrid, reflection_mode=ReflectionMode[v.upper()])
                elif k == "denoise":
                    hybrid = dataclasses.replace(hybrid, denoise=v in ("1", "true"))
                elif k == "msaa":
                    forward = dataclasses.replace(forward, msaa_samples=int(v))
                elif k == "test_alpha":
                    raytraced = dataclasses.replace(raytraced, test_alpha=v in ("1", "true"))
                else:
                    raise ValueError(f"unknown setting {k!r}")
            renderer.set_config(dataclasses.replace(
                cfg, hybrid=hybrid, forward=forward, raytraced=raytraced))
        else:
            raise ValueError(f"unknown script command {op!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="cornell",
                    help="cornell, checker, sponza, bistro, pica, realglb or a .glb / .gltf "
                    "path")
    ap.add_argument("--path", default="hybrid",
                    choices=["forward", "hybrid", "raytraced", "rayquery"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--shadows", default="raytraced",
                    choices=["raytraced", "rasterized", "off"])
    ap.add_argument("--ao", default="off", choices=["raytraced", "ssao", "off"])
    ap.add_argument("--reflections", default="off", choices=["raytraced", "ssr", "off"])
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--ssao-radius", type=float, default=0.75)
    ap.add_argument("--msaa", type=int, default=1)
    ap.add_argument("--test-alpha", action="store_true")
    ap.add_argument("--shadow-map-size", type=int, default=4096)
    ap.add_argument("--raster", default="binned", choices=["binned", "brute"],
                    help="brute: the reference rasterizer (small scenes, validation)")
    ap.add_argument("--animate", action="store_true",
                    help="per-frame transforms + BVH refit (pica scene)")
    ap.add_argument("--orbit", type=float, default=0.0,
                    help="orbit the camera by this many rad/s")
    ap.add_argument("--out", default=None, help="PNG path for the final frame")
    ap.add_argument("--dump", default=None,
                    help="name of a graph resource to dump alongside --out")
    ap.add_argument("--stats", action="store_true",
                    help="print the per-pass performance table")
    ap.add_argument("--save-checkpoint", default=None)
    ap.add_argument("--load-checkpoint", default=None)
    ap.add_argument("--script", default=None,
                    help="scripted interactive sequence, e.g. 'frames 2; path forward; "
                    "frames 1; set shadows=rasterized ao=ssao; frames 2'")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (use --device cpu)")

    config = config_from_args(args)
    scene = load_any_scene(args.scene)
    renderer = Renderer(scene, config, path=args.path, device=args.device)
    if args.load_checkpoint:
        load_checkpoint(args.load_checkpoint, renderer)

    if args.script:
        t_start = time.perf_counter()
        out = run_script(renderer, args.script)
        if out is not None:
            out = out.cpu().numpy()  # waits for the device
        wall = time.perf_counter() - t_start
        print(f"script done in {wall * 1e3:.1f} ms; {len(renderer._graphs)} render "
              "graph(s) kept")
        if args.out:
            save_png(args.out, out)
            print(f"wrote {args.out}")
        return 0

    t_start = time.perf_counter()
    for i in range(args.frames):
        if args.animate and args.scene == "pica":
            renderer.animate(procedural.animate_pica(scene, i / 60.0))
        if args.orbit:
            renderer.update_camera(1.0 / 60.0, mouse_delta=(args.orbit * 60.0, 0.0),
                                   mouse_down=True)
        out = renderer.render_frame()
    out = out.cpu().numpy()  # waits for the device
    wall = time.perf_counter() - t_start
    stats = renderer.stats
    print(f"{args.frames} frame(s) {args.width}x{args.height} [{args.path}, "
          f"{renderer.device}] in {wall * 1e3:.1f} ms ({stats.frame_ms or 0:.2f} ms/frame "
          f"EMA, {stats.fps:.1f} FPS)")
    if args.stats:
        renderer.time_passes()
        print(renderer.stats.table())
    if args.out:
        save_png(args.out, out)
        print(f"wrote {args.out}")
    if args.dump:
        p = (str(Path(args.out or "frame.png").with_suffix(""))
             + f".{args.dump.replace(' ', '_')}.png")
        renderer.debug_dump(args.dump, p, srgb=False)
        print(f"wrote {p}")
    if args.save_checkpoint:
        save_checkpoint(args.save_checkpoint, renderer)
        print(f"checkpoint -> {args.save_checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
