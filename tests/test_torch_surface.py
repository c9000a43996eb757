"""The port's Renderer surface (runtime/renderer.py: list_resources,
debug_dump, save_frame, find_nonfinite_pass, stats, profile, blue_noise),
PassStats (graph/render_graph.py), utils/bluenoise.py, utils/image.py and
procedural.bistro_proxy against the reference package's.

Exact everywhere: resource lists, the EMA arithmetic of PassStats (the same
float64 Python arithmetic), void_and_cluster (the same numpy FFTs, measured
equal) and the bistro proxy's arrays are held equal; the PNG dumps must
decode to the port's own to_uint8_image of the same resource.  Frames are
cornell at 32x32 on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.graph.render_graph import PassStats as JPassStats
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu.utils import bluenoise as jbn
from vulkanhybridrenderer_tpu.utils import image as jimage
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.graph.render_graph import PassStats
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc
from vulkanhybridrenderer_tpu_torch.utils import bluenoise as pbn
from vulkanhybridrenderer_tpu_torch.utils import image as pimage
from vulkanhybridrenderer_tpu_torch.utils import png

torch.set_num_threads(2)


def full(m, rt_scale=1):
    return m.HybridSettings(
        shadow_mode=m.ShadowMode.RAYTRACED, ao_mode=m.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=m.ReflectionMode.RAYTRACED, denoise=True, rt_scale=rt_scale)


def raster(m):
    return m.HybridSettings(shadow_mode=m.ShadowMode.RASTERIZED,
                            ao_mode=m.AmbientOcclusionMode.SSAO,
                            reflection_mode=m.ReflectionMode.SSR)


CASES = {
    "hybrid": ("hybrid", None),
    "hybrid-full": ("hybrid", full),
    "hybrid-full-rt_scale2": ("hybrid", lambda m: full(m, 2)),
    "hybrid-raster": ("hybrid", raster),
    "forward": ("forward", None),
    "raytraced": ("raytraced", None),
    "rayquery": ("rayquery", None),
}


def port_renderer(path="hybrid", hybrid=None, **kw):
    cfg = pcfg.RenderConfig(width=32, height=32, shadow_map_size=64,
                            **({} if hybrid is None else {"hybrid": hybrid}), **kw)
    return prenderer.Renderer(pproc.cornell_box(), cfg, path=path, device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_list_resources_matches_jax(case):
    path, hs = CASES[case]
    jkw = {} if hs is None else {"hybrid": hs(jcfg)}
    jr = jrenderer.Renderer(jproc.cornell_box(), jcfg.RenderConfig(
        width=32, height=32, shadow_map_size=64, **jkw), path=path)
    pr = port_renderer(path, None if hs is None else hs(pcfg))
    assert pr.list_resources() == jr.list_resources()
    assert pr.list_resources()[-1] == "RENDER_OUTPUT"


@pytest.mark.parametrize("resource, srgb", [("Depth", False), ("Albedo", True),
                                            ("RENDER_OUTPUT", True)])
def test_debug_dump_png_decodes_to_the_image(tmp_path, resource, srgb):
    r = port_renderer()
    out = tmp_path / "dump.png"
    arr = r.debug_dump(resource, out, srgb=srgb)
    assert isinstance(arr, np.ndarray)
    got = png.decode_png(out.read_bytes())
    want = pimage.to_uint8_image(arr, srgb=srgb)
    np.testing.assert_array_equal(got[..., :3], want)
    assert (got[..., 3] == 255).all()


def test_save_frame_png_decodes_to_the_frame(tmp_path):
    r = port_renderer()
    out = tmp_path / "frame.png"
    img = r.save_frame(out)
    assert img.shape == (4, 32, 32) and r.frame_index == 1
    np.testing.assert_array_equal(png.decode_png(out.read_bytes())[..., :3],
                                  pimage.to_uint8_image(img))


def test_to_uint8_image_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((4, 9, 7), (1, 9, 7), (9, 7)):
        a = rng.uniform(-0.2, 1.3, shape).astype(np.float32)
        for srgb in (True, False):
            np.testing.assert_array_equal(pimage.to_uint8_image(a, srgb),
                                          jimage.to_uint8_image(a, srgb))
    a, b = rng.uniform(0, 1, (2, 3, 5)).astype(np.float32)
    assert pimage.rmse(a, b) == jimage.rmse(a, b)


def test_find_nonfinite_pass():
    """None on a clean frame; with the light's intensity NaN the first pass
    that reads it, the Composition Pass, is named (the passes before it
    stay finite); with its projview NaN, the Geometry pass (LightClip)."""
    assert port_renderer().find_nonfinite_pass() is None
    r = port_renderer()
    light = r.scene.light
    r.scene.light = dataclasses.replace(light, intensity=np.full(4, np.nan, np.float32))
    assert r.find_nonfinite_pass() == "Composition Pass"
    r.scene.light = dataclasses.replace(light, projview=np.full((4, 4), np.nan, np.float32))
    assert r.find_nonfinite_pass() == "Geometry"  # its LightClip


def test_pass_stats_ema_matches_jax():
    rng = np.random.default_rng(1)
    js, ps = JPassStats(), PassStats()
    assert ps.fps == js.fps == 0.0
    for _ in range(7):
        t = {k: float(rng.uniform(0.1, 20)) for k in ("Geometry", "G-Buffer Pass", "SVGF")}
        ms = float(rng.uniform(5, 50))
        js.update(t)
        ps.update(t)
        js.update_frame(ms)
        ps.update_frame(ms)
        assert ps.timings == js.timings and ps.frame_ms == js.frame_ms
    assert ps.fps == js.fps
    assert ps.table() == js.table()


def test_stats_fed_by_time_passes_and_frames():
    r = port_renderer()
    assert r.stats.frame_ms is None
    r.render_frame()
    first = r.stats.frame_ms
    assert first is not None and first > 0
    t = r.time_passes(iters=1)
    assert list(r.stats.timings) == list(t) == r.graph.find_execution_order()
    r.render_frame()
    assert r.stats.frame_ms != first
    assert "[frame]" in r.stats.table()


def test_profile_writes_a_trace(tmp_path):
    r = port_renderer()
    out = tmp_path / "trace"
    assert r.profile(out, frames=1) == out
    assert r.frame_index == 2  # one untraced frame, one traced
    with open(out / f"{r.path_name}_frame2.json") as fh:
        trace = json.load(fh)
    assert trace["traceEvents"]


@pytest.mark.parametrize("seed", [0, 5])
def test_void_and_cluster_matches_jax(seed):
    np.testing.assert_array_equal(pbn.void_and_cluster(32, seed),
                                  jbn.void_and_cluster(32, seed))


def test_blue_noise_made_on_first_access_only(monkeypatch):
    """Neither the constructor nor a frame makes the blue-noise stack; the
    first access makes a (4, 128, 128, 4) tensor on the renderer's device
    from blue_noise_rgba(128, seed=i) and keeps it."""
    calls = []

    def fake(size, seed=0):
        calls.append((size, seed))
        return np.full((size, size, 4), seed, np.float32)

    monkeypatch.setattr(pbn, "blue_noise_rgba", fake)
    r = port_renderer()
    r.render_frame()
    assert calls == [] and r._blue_noise is None
    bn = r.blue_noise
    assert calls == [(128, i) for i in range(4)]
    assert bn.shape == (4, 128, 128, 4) and bn.device == r.device
    assert bn.dtype == torch.float32 and float(bn[3, 0, 0, 0]) == 3.0
    assert r.blue_noise is bn and len(calls) == 4


def test_bistro_proxy_matches_jax():
    js, ps = jproc.bistro_proxy(), pproc.bistro_proxy()
    assert js.name == ps.name == "BistroProxy"
    jb, pb = js.buffers, ps.buffers
    assert pb.num_triangles == jb.num_triangles == 434_460
    assert pb.num_vertices == jb.num_vertices
    assert pb.prim_transform.shape == np.asarray(jb.prim_transform).shape
    assert pb.alpha_tri_idx.shape == np.asarray(jb.alpha_tri_idx).shape
    assert pb.atlas.data.shape == np.asarray(jb.atlas.data).shape
    for f in ("positions", "tri_vertex", "tri_prim", "prim_transform"):
        np.testing.assert_array_equal(getattr(pb, f), np.asarray(getattr(jb, f)), err_msg=f)
