"""Live interactive viewer (port of ``runtime/viewer.py``): the stand-in
for the reference's ImGui layer (user_interface.cpp:81-159).  Fly the camera,
switch render paths and per-path settings live (applied between frames, like
renderer.cpp:159-181), watch the per-pass table, and view any named graph
resource (the debug-texture dropdown, user_interface.cpp:129-150).

A dependency-free localhost HTTP server wraps a Renderer.  The browser page
polls PNG frames (encoded by ``utils/png``) and posts key and settings
events; all rendering stays in the Python process.

Run:  python -m vulkanhybridrenderer_tpu_torch.runtime.viewer [--scene cornell]
      [--path hybrid] [--width 640] [--height 400] [--port 8321] [--device cpu]
then open http://localhost:8321/.  Frames run on CUDA unless ``--device cpu``
is given; without a GPU the viewer stops with an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from vulkanhybridrenderer_tpu_torch.core.config import (
    AmbientOcclusionMode,
    ReflectionMode,
    RenderConfig,
    ShadowMode,
)
from vulkanhybridrenderer_tpu_torch.runtime.app import load_any_scene
from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
from vulkanhybridrenderer_tpu_torch.scene import procedural
from vulkanhybridrenderer_tpu_torch.utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>vulkanhybridrenderer_tpu_torch</title><style>
body { background:#14161a; color:#d8dce2; font:13px monospace; margin:16px }
#frame { image-rendering:pixelated; border:1px solid #333; outline:none }
#hud { white-space:pre; margin-top:8px; color:#9aa3ad }
select,button { background:#22262c; color:#d8dce2; border:1px solid #444;
                font:12px monospace; margin-right:6px }
.row { margin:6px 0 }
</style></head><body>
<div class="row">
 <select id="path"><option>hybrid</option><option>forward</option>
   <option>raytraced</option><option>rayquery</option></select>
 <select id="resource"><option value="">RENDER_OUTPUT</option></select>
 <button id="shadow">shadow: ?</button>
 <button id="ao">ao: ?</button>
 <button id="refl">refl: ?</button>
 <button id="denoise">denoise: ?</button>
 <button id="msaa">msaa: ?</button>
 <button id="test_alpha">test_alpha: ?</button>
</div>
<div class="row" id="params">
 <label>ssao.radius <input type="range" id="ssao_radius" min="0.1" max="5"
   step="0.05"><span></span></label>
 <label>ssr.ray_distance <input type="range" id="ssr_ray_distance" min="0.1"
   max="40" step="0.1"><span></span></label>
 <label>ssr.step_size <input type="range" id="ssr_step_size" min="0.01"
   max="5" step="0.01"><span></span></label>
 <label>ssr.thickness <input type="range" id="ssr_thickness" min="0" max="3"
   step="0.05"><span></span></label>
 <label>ssr.bsearch_steps <input type="range" id="ssr_bsearch_steps" min="1"
   max="100" step="1"><span></span></label>
 <label>rt_scale <input type="range" id="rt_scale" min="1" max="4"
   step="1"><span></span></label>
</div>
<img id="frame" tabindex="0" width="WIDTH" height="HEIGHT">
<div id="hud">connecting…</div>
<script>
const img = document.getElementById('frame');
const hud = document.getElementById('hud');
const keys = new Set();
img.addEventListener('keydown', e => { keys.add(e.key.toLowerCase()); e.preventDefault(); });
img.addEventListener('keyup',   e => { keys.delete(e.key.toLowerCase()); });
let dragging = false, lastX = 0, lastY = 0, dx = 0, dy = 0;
img.addEventListener('mousedown', e => { dragging = true; lastX = e.clientX; lastY = e.clientY; img.focus(); });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (dragging) { dx += e.clientX - lastX; dy += e.clientY - lastY;
                  lastX = e.clientX; lastY = e.clientY; }
});
for (const id of ['shadow','ao','refl','denoise','msaa','test_alpha'])
  document.getElementById(id).onclick = () =>
    fetch('/toggle?k=' + id).then(r => r.json()).then(updateButtons);
const PARAMS = ['ssao_radius','ssr_ray_distance','ssr_step_size',
                'ssr_thickness','ssr_bsearch_steps','rt_scale'];
for (const id of PARAMS) {
  const el = document.getElementById(id);
  el.addEventListener('input', () =>
    el.nextElementSibling.textContent = el.value);
  // 'change' (release), not 'input': each value is a new static config
  // -> deferred rebuild, like the reference's pipeline-rebuild-on-release
  el.addEventListener('change', () =>
    fetch('/set?param=' + id + '&value=' + el.value));
}
document.getElementById('path').onchange = e =>
  fetch('/set?path=' + e.target.value);
document.getElementById('resource').onchange = e =>
  fetch('/set?resource=' + encodeURIComponent(e.target.value));
function updateButtons(s) {
  for (const id of ['shadow','ao','refl','denoise','msaa','test_alpha'])
    document.getElementById(id).textContent = id + ': ' + s[id];
  if (s.params)
    for (const id of PARAMS) {
      const el = document.getElementById(id);
      if (document.activeElement !== el && s.params[id] !== undefined) {
        el.value = s.params[id];
        el.nextElementSibling.textContent = s.params[id];
      }
    }
  const sel = document.getElementById('resource');
  if (sel.options.length <= 1 && s.resources)
    for (const r of s.resources) {
      const o = document.createElement('option'); o.value = r; o.text = r;
      sel.add(o);
    }
}
async function loop() {
  const q = new URLSearchParams({keys: [...keys].join(''),
                                 dx: dx, dy: dy, drag: dragging ? 1 : 0});
  dx = 0; dy = 0;
  try {
    const r = await fetch('/frame?' + q);
    const meta = JSON.parse(r.headers.get('x-meta'));
    const blob = await r.blob();
    img.src = URL.createObjectURL(blob);
    hud.textContent = meta.hud;
    updateButtons(meta.state);
  } catch (e) { hud.textContent = 'disconnected: ' + e; }
  setTimeout(loop, 10);
}
loop();
</script></body></html>"""


class ViewerState:
    def __init__(self, scene, config, path, device="cuda"):
        self.lock = threading.Lock()
        self.renderer = Renderer(scene, config, path=path, device=device)
        self.resource = ""  # "" = RENDER_OUTPUT
        self.last_t = time.time()

    # -- settings (deferred switch semantics: applied between frames) ---------
    def set_path(self, name):
        with self.lock:
            self.renderer.set_path(name)

    def toggle(self, key):
        with self.lock:
            cfg = self.renderer.config
            s = cfg.hybrid
            if key == "shadow":
                nxt = {ShadowMode.RAYTRACED: ShadowMode.RASTERIZED,
                       ShadowMode.RASTERIZED: ShadowMode.OFF,
                       ShadowMode.OFF: ShadowMode.RAYTRACED}[s.shadow_mode]
                s = dataclasses.replace(s, shadow_mode=nxt)
            elif key == "ao":
                nxt = {AmbientOcclusionMode.OFF: AmbientOcclusionMode.SSAO,
                       AmbientOcclusionMode.SSAO: AmbientOcclusionMode.RAYTRACED,
                       AmbientOcclusionMode.RAYTRACED: AmbientOcclusionMode.OFF,
                       }[s.ao_mode]
                s = dataclasses.replace(s, ao_mode=nxt)
            elif key == "refl":
                nxt = {ReflectionMode.OFF: ReflectionMode.SSR,
                       ReflectionMode.SSR: ReflectionMode.RAYTRACED,
                       ReflectionMode.RAYTRACED: ReflectionMode.OFF,
                       }[s.reflection_mode]
                s = dataclasses.replace(s, reflection_mode=nxt)
            elif key == "denoise":
                s = dataclasses.replace(s, denoise=not s.denoise)
            elif key == "msaa":
                # forward path MSAA enable/disable
                # (forward_raster_render_path.cpp:100-106)
                fw = dataclasses.replace(
                    cfg.forward,
                    msaa_samples=4 if cfg.forward.msaa_samples == 1 else 1,
                )
                self.renderer.set_config(
                    dataclasses.replace(cfg, forward=fw)
                )
                return self.state()
            elif key == "test_alpha":
                # raytraced path shadow alpha test
                # (raytraced_render_path.cpp:80-86)
                rt = dataclasses.replace(
                    cfg.raytraced, test_alpha=not cfg.raytraced.test_alpha
                )
                self.renderer.set_config(
                    dataclasses.replace(cfg, raytraced=rt)
                )
                return self.state()
            self.renderer.set_config(dataclasses.replace(cfg, hybrid=s))
        return self.state()

    def set_param(self, name, value):
        """Live numeric settings — the reference's per-path ImGui sliders
        (hybrid_render_path.cpp:423-432) plus the rt_scale knob.  Every
        value is part of the config, so a change takes effect at the next
        frame (a graph per config), like the slider-driven push-constant
        pipelines rebuilding on release."""
        with self.lock:
            cfg = self.renderer.config
            s = cfg.hybrid
            if name == "ssao_radius":
                s = dataclasses.replace(
                    s, ssao=dataclasses.replace(s.ssao, radius=float(value))
                )
            elif name.startswith("ssr_"):
                field = name[4:]
                cast = int if field == "bsearch_steps" else float
                s = dataclasses.replace(
                    s, ssr=dataclasses.replace(s.ssr, **{field: cast(value)})
                )
            elif name == "rt_scale":
                s = dataclasses.replace(s, rt_scale=max(1, int(float(value))))
            else:
                raise KeyError(name)
            self.renderer.set_config(dataclasses.replace(cfg, hybrid=s))

    def state(self):
        s = self.renderer.config.hybrid
        out = {
            "shadow": s.shadow_mode.name.lower(),
            "ao": s.ao_mode.name.lower(),
            "refl": s.reflection_mode.name.lower(),
            "denoise": "on" if s.denoise else "off",
            "msaa": f"{self.renderer.config.forward.msaa_samples}x",
            "test_alpha": (
                "on" if self.renderer.config.raytraced.test_alpha else "off"
            ),
            "params": {
                "ssao_radius": s.ssao.radius,
                "ssr_ray_distance": s.ssr.ray_distance,
                "ssr_step_size": s.ssr.step_size,
                "ssr_thickness": s.ssr.thickness,
                "ssr_bsearch_steps": s.ssr.bsearch_steps,
                "rt_scale": s.rt_scale,
            },
        }
        out["resources"] = self.renderer.list_resources()
        return out

    # -- frame ----------------------------------------------------------------
    def frame_png(self, keys, mouse_dx, mouse_dy, dragging):
        with self.lock:
            now = time.time()
            dt = min(0.1, now - self.last_t)
            self.last_t = now
            self.renderer.update_camera(
                dt, keys=frozenset(keys),
                mouse_delta=(mouse_dx, mouse_dy), mouse_down=dragging,
            )
            if self.resource:
                arr = self.renderer.fetch_resource(self.resource)
                png = encode_png(arr.cpu().numpy(), srgb=False)
            else:
                img = self.renderer.render_frame(srgb8=True).cpu().numpy()
                png = encode_png(img, srgb=False, already_u8=True)
            hud = self.renderer.stats.table()
        return png, hud


def make_handler(state: ViewerState, width: int, height: int):
    page = _PAGE.replace("WIDTH", str(width * 2)).replace(
        "HEIGHT", str(height * 2)
    )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="text/html", extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            if u.path == "/":
                self._send(200, page.encode())
            elif u.path == "/frame":
                png, hud = state.frame_png(
                    set(q.get("keys", "")),
                    float(q.get("dx", 0)), float(q.get("dy", 0)),
                    q.get("drag") == "1",
                )
                meta = json.dumps({"hud": hud, "state": state.state()})
                self._send(200, png, "image/png", [("x-meta", meta)])
            elif u.path == "/toggle":
                self._send(200, json.dumps(state.toggle(q["k"])).encode(),
                           "application/json")
            elif u.path == "/set":
                if "path" in q:
                    state.set_path(q["path"])
                if "resource" in q:
                    state.resource = q["resource"]
                if "param" in q:
                    state.set_param(q["param"], q.get("value", "0"))
                self._send(200, b"{}", "application/json")
            else:
                self._send(404, b"not found")

    return Handler


def serve(scene=None, config=None, path="hybrid", port=8321, block=True,
          device="cuda"):
    scene = scene or procedural.cornell_box()
    config = config or RenderConfig(width=480, height=320, shadow_map_size=512)
    state = ViewerState(scene, config, path, device=device)
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", port), make_handler(state, config.width, config.height)
    )
    print(f"viewer: http://127.0.0.1:{httpd.server_address[1]}/  (WASD + drag to fly)")
    if block:
        httpd.serve_forever()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
    return httpd, state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell",
                    help="cornell, checker, sponza, bistro, pica, realglb or a .glb / .gltf "
                    "path")
    ap.add_argument("--path", default="hybrid")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--port", type=int, default=8321)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (use --device cpu)")
    cfg = RenderConfig(width=args.width, height=args.height, shadow_map_size=1024)
    serve(load_any_scene(args.scene), cfg, path=args.path, port=args.port,
          device=args.device)


if __name__ == "__main__":
    main()
