"""The port's app shell (runtime/app.py) and live viewer (runtime/viewer.py)
with --device cpu: the port's side of test_app_script.py, test_viewer.py and
test_misc_utils.py.

Scripted mode switches keep one render graph per (path, config); a CLI run
writes a PNG; a checkpoint restores camera, path, config and the SVGF
temporal state, so the restored renderer's next frame equals the original's
next frame exactly (both on the CPU; measured equal); the viewer's state()
has the reference viewer's keys and its frames decode.  The HTTP test talks
to the viewer on 127.0.0.1 only.
"""
import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.runtime import viewer as jviewer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.runtime import app, viewer
from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
from vulkanhybridrenderer_tpu_torch.scene import procedural
from vulkanhybridrenderer_tpu_torch.utils import png

torch.set_num_threads(2)
SMALL = ["--scene", "cornell", "--width", "48", "--height", "48",
         "--shadow-map-size", "64", "--device", "cpu"]


def test_script_mode_switches():
    r = Renderer(procedural.cornell_box(),
                 pcfg.RenderConfig(width=48, height=48, shadow_map_size=64), device="cpu")
    out = app.run_script(
        r,
        "frames 1; path forward; frames 1; path hybrid; "
        "set shadows=rasterized ao=ssao; frames 1; "
        "set shadows=raytraced ao=raytraced reflections=raytraced denoise=true; "
        "frames 2; camera w; frames 1",
    )
    img = out.numpy()
    assert np.isfinite(img).all() and (img[3] > 0).any()
    assert r.path_name == "hybrid" and r.config.hybrid.denoise
    assert len(r._graphs) == 4  # four (path, config) pairs
    app.run_script(r, "set denoise=false shadows=rasterized ao=ssao reflections=off; "
                      "frames 1")
    assert len(r._graphs) == 4  # switching back reuses a graph
    with pytest.raises(ValueError):
        app.run_script(r, "set bloom=1")


def test_cli_writes_png(tmp_path, capsys):
    out = tmp_path / "f.png"
    assert app.main(SMALL + ["--script", "frames 1; path forward; frames 1",
                             "--out", str(out)]) == 0
    assert png.decode_png(out.read_bytes()).shape == (48, 48, 4)
    out2 = tmp_path / "g.png"
    assert app.main(SMALL + ["--frames", "2", "--stats", "--out", str(out2),
                             "--dump", "Depth"]) == 0
    text = capsys.readouterr().out
    assert "[frame]" in text and "Raytrace Pass" in text
    assert png.decode_png(out2.read_bytes()).shape == (48, 48, 4)
    assert (tmp_path / "g.Depth.png").exists()


def test_cli_needs_cuda_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        app.main(["--scene", "cornell", "--width", "16", "--height", "16"])
    with pytest.raises(SystemExit):
        viewer.main(["--scene", "cornell"])


@pytest.mark.parametrize("flag, item", [(["--raster", "brute"], "item 14"),
                                        (["--animate"], "item 15")])
def test_unported_options_raise(flag, item, tmp_path):
    """--raster brute (ROADMAP item 14) and --animate (item 15) raised
    NotImplementedError until they were ported; now they reach the config
    and a run writes its frame."""
    out = tmp_path / "f.png"
    assert app.main(SMALL + flag + ["--frames", "2", "--out", str(out)]) == 0
    assert png.decode_png(out.read_bytes()).shape == (48, 48, 4)


def test_load_any_scene(tmp_path, monkeypatch):
    assert app.load_any_scene("cornell").name == "CornellBox"
    assert app.load_any_scene("pica").name == "PicaProxy"
    glb = tmp_path / "realglb.glb"
    monkeypatch.setattr(app, "REALGLB_PATH", glb)
    scene = app.load_any_scene("realglb")
    assert scene.buffers.num_triangles == 254_636
    stamp = glb.stat().st_mtime_ns
    assert app.load_any_scene(str(glb)).buffers.num_triangles == 254_636
    app.load_any_scene("realglb")
    assert glb.stat().st_mtime_ns == stamp  # written once, then read


def test_checkpoint_round_trip(tmp_path):
    full = pcfg.HybridSettings(
        shadow_mode=pcfg.ShadowMode.RAYTRACED, ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=pcfg.ReflectionMode.RAYTRACED, denoise=True)
    cfg = pcfg.RenderConfig(width=32, height=24, alpha_raster="off", hybrid=full)
    r = Renderer(procedural.cornell_box(), cfg, device="cpu")
    r.update_camera(0.05, keys={"w", "a"}, mouse_delta=(3.0, -2.0), mouse_down=True)
    for _ in range(2):
        r.render_frame()
    path = tmp_path / "ckpt.npz"
    app.save_checkpoint(path, r)

    other = Renderer(procedural.cornell_box(), pcfg.RenderConfig(width=16, height=16),
                     path="forward", device="cpu")
    app.load_checkpoint(path, other)
    assert other.path_name == "hybrid" and other.config == cfg
    assert other.frame_index == r.frame_index == 2
    for f in dataclasses.fields(r.scene.camera):
        np.testing.assert_array_equal(np.asarray(getattr(other.scene.camera, f.name)),
                                      np.asarray(getattr(r.scene.camera, f.name)))
    for f in dataclasses.fields(r.temporal_state):
        a, b = getattr(other.temporal_state, f.name), getattr(r.temporal_state, f.name)
        assert a.device == other.device
        assert torch.equal(a, b), f.name
    # the previous frame's matrices are not saved: the restored renderer's
    # first frame reprojects with its own view, as after a camera cut
    other._prev_view, other._prev_proj = r._prev_view, r._prev_proj
    assert torch.equal(other.render_frame(), r.render_frame())


def test_viewer_state_keys_match_jax():
    jstate = jviewer.ViewerState(jproc.cornell_box(), jcfg.RenderConfig(
        width=32, height=32, shadow_map_size=64), "hybrid")
    pstate = viewer.ViewerState(procedural.cornell_box(), pcfg.RenderConfig(
        width=32, height=32, shadow_map_size=64), "hybrid", device="cpu")
    js, ps = jstate.state(), pstate.state()
    assert sorted(ps) == sorted(js)
    assert ps == js
    for key in ("shadow", "ao", "refl", "denoise", "msaa", "test_alpha"):
        assert pstate.toggle(key) == jstate.toggle(key)
    png_bytes, hud = pstate.frame_png({"w"}, 1.0, 0.0, True)
    assert png.decode_png(png_bytes).shape == (32, 32, 4)
    assert "[frame]" in hud


def test_viewer_endpoints():
    cfg = pcfg.RenderConfig(width=96, height=64, shadow_map_size=64)
    httpd, state = viewer.serve(procedural.cornell_box(), cfg, path="forward", port=0,
                                block=False, device="cpu")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert b"vulkanhybridrenderer_tpu_torch" in urllib.request.urlopen(base + "/").read()
        r = urllib.request.urlopen(base + "/frame?keys=&dx=0&dy=0&drag=0")
        frame = png.decode_png(r.read())
        assert frame.shape == (64, 96, 4)
        meta = json.loads(r.headers["x-meta"])
        assert "RENDER_OUTPUT" in meta["state"]["resources"]
        pos0 = state.renderer.scene.camera.position.copy()
        urllib.request.urlopen(base + "/frame?keys=w&dx=0&dy=0&drag=0").read()
        assert not np.allclose(state.renderer.scene.camera.position, pos0)
        s = json.loads(urllib.request.urlopen(base + "/toggle?k=ao").read())
        assert s["ao"] == "ssao"
        urllib.request.urlopen(base + "/set?path=hybrid").read()
        urllib.request.urlopen(base + "/set?resource=Depth").read()
        depth = png.decode_png(urllib.request.urlopen(
            base + "/frame?keys=&dx=0&dy=0&drag=0").read())
        assert depth.shape == (64, 96, 4) and state.renderer.path_name == "hybrid"
        urllib.request.urlopen(base + "/set?param=ssao_radius&value=1.5").read()
        urllib.request.urlopen(base + "/set?param=ssr_bsearch_steps&value=9").read()
        urllib.request.urlopen(base + "/set?param=rt_scale&value=2").read()
        h = state.renderer.config.hybrid
        assert (h.ssao.radius, h.ssr.bsearch_steps, h.rt_scale) == (1.5, 9, 2)
        s2 = json.loads(urllib.request.urlopen(base + "/toggle?k=msaa").read())
        assert s2["msaa"] == "4x" and state.renderer.config.forward.msaa_samples == 4
        urllib.request.urlopen(base + "/set?resource=").read()
        last = png.decode_png(urllib.request.urlopen(
            base + "/frame?keys=&dx=0&dy=0&drag=0").read())
        assert last.shape == (64, 96, 4)
        assert urllib.request.urlopen(base + "/frame?keys=").status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
