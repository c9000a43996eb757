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


@pytest.mark.parametrize("change, brings", [
    (dict(shadow_accel="grid"), "Shadow Grid Build"),
    (dict(raster="brute"), "G-Buffer Pass"),
    (dict(animated=True), "BVH Refit"),
])
def test_unported_modes_raise(change, brings):
    """The modes that raised NotImplementedError until they were ported
    (the shadow grid, the brute rasterizer, animation) build their graph and
    render; what still raises is the reference's own NotImplementedError:
    the binned raster with a depth preset other than reverse-Z
    greater_equal.  test_torch_hybrid_grid.py, test_torch_brute.py and
    test_torch_animated.py hold them against the JAX package."""
    cfg = dataclasses.replace(pcfg.RenderConfig(width=W, height=H, alpha_raster="off",
                                                shadow_map_size=128), **change)
    r = prenderer.Renderer(pproc.cornell_box(), cfg, device="cpu")
    assert brings in r.graph.find_execution_order()
    assert bool(torch.isfinite(r.render_frame()).all())
    preset = pcfg.RasterState(depth_compare="less_equal", depth_clear=1.0)
    binned = prenderer.Renderer(pproc.cornell_box(), dataclasses.replace(
        cfg, raster="binned", raster_state=preset), device="cpu")
    with pytest.raises(NotImplementedError, match="greater_equal"):
        binned.render_frame()


def test_unported_paths_and_options_raise():
    """The raytraced and rayquery paths render (test_ported_paths_render),
    animated too (a BVH Refit pass), and the rayquery path with the brute
    rasterizer; the binned raster with another depth preset raises the
    reference's NotImplementedError.  The BVH table knobs are held to the
    reference's by test_bvh_table_knobs_as_reference."""
    for path in ("raytraced", "rayquery"):
        r = prenderer.Renderer(pproc.cornell_box(),
                               pcfg.RenderConfig(width=W, height=H, alpha_raster="off",
                                                 animated=True),
                               path=path, device="cpu")
        assert "BVH Refit" in r.graph.find_execution_order()
        assert bool(torch.isfinite(r.render_frame()).all())
    rq = prenderer.Renderer(pproc.cornell_box(),
                            pcfg.RenderConfig(width=W, height=H, raster="brute"),
                            path="rayquery", device="cpu")
    assert bool(torch.isfinite(rq.render_frame()).all())
    with pytest.raises(NotImplementedError, match="greater_equal"):
        prenderer.Renderer(pproc.cornell_box(), pcfg.RenderConfig(
            width=W, height=H, raster_state=pcfg.RasterState(depth_clear=1.0)),
            path="rayquery", device="cpu").render_frame()


@pytest.mark.parametrize("animated", [False, True])
@pytest.mark.parametrize("leaf_max", [0, 8, 12, 4])
@pytest.mark.parametrize("dtype", ["auto", "f32", "bf16", "fp8"])
def test_bvh_table_knobs_as_reference(dtype, leaf_max, animated):
    """RenderConfig's bvh_dtype, bvh_leaf_max and animated: the port
    accepts exactly the combinations the reference accepts (dtype in auto /
    f32 / bf16, leaf_max in 0 / 8 / 12, bf16 neither with 12 nor animated)
    and raises ValueError on the others, as the reference does; both
    default to ("auto", 0)."""
    kw = dict(bvh_dtype=dtype, bvh_leaf_max=leaf_max, animated=animated)
    accepted = []
    for m in (jcfg, pcfg):
        try:
            m.RenderConfig(**kw)
            accepted.append(True)
        except ValueError:
            accepted.append(False)
    assert accepted[0] == accepted[1]
    assert accepted[1] == (dtype != "fp8" and leaf_max != 4
                           and not (dtype == "bf16" and (leaf_max == 12 or animated)))
    for m in (jcfg, pcfg):
        assert (m.RenderConfig().bvh_dtype, m.RenderConfig().bvh_leaf_max) == ("auto", 0)


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


RT_AO = pcfg.AmbientOcclusionMode.RAYTRACED
RASTERIZED_SHADOWS = pcfg.ShadowMode.RASTERIZED
SHADOWS_OFF = pcfg.ShadowMode.OFF


@pytest.fixture(scope="module")
def small_sponza():
    """The small Sponza proxy's RT-shadows frame, its RT AO frame and its
    frame without shadows, each the second frame rendered (SVGF has no
    history, hence no variance, on the first)."""
    scene = pproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    cfg = pcfg.RenderConfig(width=W, height=H, alpha_raster="off")
    ao_cfg = dataclasses.replace(cfg, hybrid=pcfg.HybridSettings(ao_mode=RT_AO))
    off_cfg = dataclasses.replace(cfg, hybrid=pcfg.HybridSettings(shadow_mode=SHADOWS_OFF))
    return scene, cfg, {name: _second_frame(scene, c)
                        for name, c in (("rt_shadows", cfg), ("rt_ao", ao_cfg),
                                        ("shadows_off", off_cfg))}


def _second_frame(scene, cfg):
    r = prenderer.Renderer(scene, cfg, device="cpu")
    r.render_frame()
    return r.render_frame()


@pytest.mark.parametrize("change,differs_from", [
    (dict(hybrid=pcfg.HybridSettings(ao_mode=RT_AO)), ("rt_shadows",)),
    (dict(hybrid=pcfg.HybridSettings(ao_mode=RT_AO, denoise=True)), ("rt_shadows", "rt_ao")),
    (dict(alpha_raster="brute"), ("rt_shadows",)),
    (dict(shadow_map_size=128, hybrid=pcfg.HybridSettings(shadow_mode=RASTERIZED_SHADOWS)),
     ("rt_shadows",)),
    # the proxy's closed hall shadows every pixel from the light, and
    # composition scales reflections by the shadow: SSR shows with shadows off
    (dict(hybrid=pcfg.HybridSettings(shadow_mode=SHADOWS_OFF,
                                     reflection_mode=pcfg.ReflectionMode.SSR)),
     ("shadows_off",)),
    (dict(hybrid=pcfg.HybridSettings(ao_mode=pcfg.AmbientOcclusionMode.SSAO)),
     ("rt_shadows", "rt_ao")),
    # half-resolution RT: shadows traced at 1/2 and upsampled
    (dict(hybrid=pcfg.HybridSettings(rt_scale=2)), ("rt_shadows",)),
    (dict(hybrid=pcfg.HybridSettings(ao_mode=RT_AO, denoise=True, rt_scale=2)),
     ("rt_shadows", "rt_ao")),
])
def test_ported_modes_render(small_sponza, change, differs_from):
    """RT AO, SVGF, the alpha peel, rasterized (shadow-map + PCF) shadows,
    SSR and SSAO over the RT-shadows frame (they raised NotImplementedError
    before they were ported): finite, and not the frames without them.  SVGF
    is rendered over RT AO: on the proxy's hard RT shadows alone it is an
    identity (zero variance stops every a-trous tap).  Each is the second
    frame rendered, with the history of the first.
    test_torch_hybrid_full*.py and test_torch_hybrid_raster.py hold them
    against the JAX renderer."""
    scene, cfg, base = small_sponza
    img = _second_frame(scene, dataclasses.replace(cfg, **change))
    assert bool(torch.isfinite(img).all())
    for name in differs_from:
        assert img.shape == base[name].shape
        assert float((img - base[name]).abs().max()) > 1e-3, name


@pytest.mark.parametrize("path", ["raytraced", "rayquery"])
def test_ported_paths_render(small_sponza, path):
    """The raytraced and rayquery paths (they raised NotImplementedError
    before they were ported): finite, an image, and not the hybrid frame
    without shadows (the closed hall shadows every pixel, so the raytraced
    frame's ambient-only shading matches the hybrid RT-shadows frame).
    test_torch_raytraced.py and test_torch_rayquery.py hold them against the
    JAX renderer."""
    scene, cfg, base = small_sponza
    img = prenderer.Renderer(scene, cfg, path=path, device="cpu").render_frame()
    assert bool(torch.isfinite(img).all()) and img.shape == base["shadows_off"].shape
    assert float(img[:3].std()) > 0.01
    assert float((img - base["shadows_off"]).abs().max()) > 1e-3
