"""The port's whole hybrid RT-shadows frame against the JAX renderer.

Both packages render from exactly the same scene arrays (the port's scene is
built from the JAX scene through ``bridge.scene_from_numpy``) at 96x64, frames
0 (the degenerate all-zero RNG seed) and 1.  Tolerance: 1e-4 on >= 99.9% of
pixels - XLA contracts multiply-adds into FMAs and uses its own sin / cos, so a
shadow ray grazing a silhouette may flip; everything else agrees to ~1e-6.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.graph.render_graph import GraphError, RenderGraph
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
W, H = 96, 64
GOLDEN = Path(__file__).parent / "goldens" / "hybrid_rt_shadows_cornell.npy"


def _jax_scene(name):
    if name == "cornell":
        return jproc.cornell_box()
    return jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)


@pytest.fixture(scope="module", params=["cornell", "sponza"])
def frames(request):
    """Frames 0 and 1 of one scene from both renderers (JAX rendered once
    per scene for the whole module)."""
    js = _jax_scene(request.param)
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, alpha_raster="off",
        shadow_map_size=128,
    ), path="hybrid")
    # the blue-noise stack rides along for user pipelines and no pass reads
    # it; generating it costs minutes on a CPU, so hand the renderer zeros
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(width=W, height=H, alpha_raster="off"),
                            device="cpu")
    return [(np.asarray(jr.render_frame()), pr.render_frame().numpy()) for _ in range(2)]


@pytest.mark.parametrize("frame", [0, 1])
def test_frame_matches_jax(frames, frame):
    j, p = frames[frame]
    assert p.shape == j.shape == (4, H, W)
    assert np.isfinite(p).all()
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01  # a real image, not a constant


def test_cornell_golden():
    r = prenderer.Renderer(pproc.cornell_box(),
                           pcfg.RenderConfig(width=64, height=64, alpha_raster="off"),
                           device="cpu")
    img = r.render_frame().numpy()
    golden = np.load(GOLDEN).astype(np.float32)
    err = float(np.sqrt(np.mean((np.clip(img, 0, 1) - np.clip(golden, 0, 1)) ** 2)))
    assert err <= 2e-3, err


def test_shadows_off_and_srgb8():
    sc = pproc.cornell_box()
    cfg = pcfg.RenderConfig(width=W, height=H, alpha_raster="off")
    rt = prenderer.Renderer(sc, cfg, device="cpu")
    off = prenderer.Renderer(sc, dataclasses.replace(
        cfg, hybrid=pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.OFF)), device="cpu")
    a, b = rt.render_frame(), off.render_frame()
    assert (b >= a - 1e-6).all() and (b - a).max() > 0.05  # shadows only darken
    assert "Raytrace Pass" not in off.graph.find_execution_order()
    img8 = rt.render_frame(srgb8=True)
    assert img8.dtype == torch.uint8 and img8.shape == (H, W, 4)
    ref8 = np.asarray(jrenderer._encode_srgb8(jnp.asarray(a.numpy())))
    got8 = prenderer._encode_srgb8(a).numpy()
    assert np.abs(got8.astype(int) - ref8.astype(int)).max() <= 1  # pow rounding
    assert set(rt.time_passes(iters=1)) == {
        "Geometry", "G-Buffer Pass", "BVH", "Raytrace Pass", "Composition Pass"}


@pytest.mark.parametrize("change", [
    dict(hybrid=pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.RASTERIZED)),
    dict(hybrid=pcfg.HybridSettings(ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED)),
    dict(hybrid=pcfg.HybridSettings(reflection_mode=pcfg.ReflectionMode.SSR)),
    dict(hybrid=pcfg.HybridSettings(ao_mode=pcfg.AmbientOcclusionMode.SSAO)),
    dict(hybrid=pcfg.HybridSettings(denoise=True)),
    dict(hybrid=pcfg.HybridSettings(rt_scale=2)),
    dict(alpha_raster="brute"),
    dict(raster="brute"),
    dict(animated=True),
])
def test_unported_modes_raise(change):
    cfg = dataclasses.replace(pcfg.RenderConfig(width=W, height=H, alpha_raster="off"), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prenderer.Renderer(pproc.cornell_box(), cfg, device="cpu")


def test_unported_paths_and_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        prenderer.Renderer(pproc.cornell_box(), pcfg.RenderConfig(alpha_raster="off"),
                           path="forward", device="cpu")
    with pytest.raises(ValueError):
        pcfg.RenderConfig(bvh_dtype="bf16")
    with pytest.raises(ValueError):
        pcfg.RenderConfig(bvh_leaf_max=12)


def test_render_graph_order_and_errors():
    g = RenderGraph()
    g.add_pass("a", lambda r: {"A": r["x"] + 1}, inputs=("x",), outputs=("A",))
    g.add_pass("unused", lambda r: {"U": 0}, inputs=("x",), outputs=("U",))
    g.add_pass("out", lambda r: {"RENDER_OUTPUT": r["A"] * 2}, inputs=("A",),
               outputs=("RENDER_OUTPUT",))
    assert g.find_execution_order() == ["a", "out"]  # "unused" is pruned
    assert g.run({"x": 1})["RENDER_OUTPUT"] == 4
    with pytest.raises(GraphError):
        g.run({})  # x is neither produced nor external
    with pytest.raises(GraphError):
        g.add_pass("a", lambda r: {}, inputs=(), outputs=())
    g2 = RenderGraph()
    g2.add_pass("p", lambda r: {"P": 0}, inputs=("Q",), outputs=("P",))
    g2.add_pass("q", lambda r: {"Q": 0}, inputs=("P",), outputs=("Q", "RENDER_OUTPUT"))
    with pytest.raises(GraphError, match="cycle"):
        g2.find_execution_order()
