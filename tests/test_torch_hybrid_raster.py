"""The port's raster-mode hybrid frame (rasterized shadows through the shadow
map and PCF, SSAO, with and without SSR) against the JAX renderer on the
small Sponza proxy at 96x64 (shadow_map_size 128, alpha off as bench.py sets
for explicit modes), frames 0 and 1; and the reference's golden of the mode.

Tolerance: 1e-3 on >= 99.9% of pixels (measured: every pixel within 3.1e-5
without SSR; with SSR 0.99984 of pixels within 1e-4, one pixel off by
1.4e-3, where a march step flips between the two setups' rounding).
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
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
W, H = 96, 64
GOLDEN = Path(__file__).parent / "goldens" / "hybrid_raster_shadows_ssao.npy"


def _settings(cfg, ssr: bool):
    return cfg.HybridSettings(
        shadow_mode=cfg.ShadowMode.RASTERIZED, ao_mode=cfg.AmbientOcclusionMode.SSAO,
        reflection_mode=cfg.ReflectionMode.SSR if ssr else cfg.ReflectionMode.OFF)


@pytest.fixture(scope="module", params=[False, True], ids=["no_ssr", "ssr"])
def frames(request):
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, shadow_map_size=128,
        alpha_raster="off", hybrid=_settings(jcfg, request.param)), path="hybrid")
    # no pass reads the blue-noise stack; generating it costs minutes
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(
        width=W, height=H, shadow_map_size=128, alpha_raster="off",
        hybrid=_settings(pcfg, request.param)), device="cpu")
    return [(np.asarray(jr.render_frame()), pr.render_frame().numpy()) for _ in range(2)]


@pytest.mark.parametrize("frame", [0, 1])
def test_raster_hybrid_matches_jax(frames, frame):
    j, p = frames[frame]
    assert p.shape == j.shape == (4, H, W)
    assert np.isfinite(p).all()
    close = np.abs(p - j).max(axis=0) <= 1e-3
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01


def test_raster_hybrid_golden_and_passes():
    """The reference's golden (cornell 64x64, RMSE <= 2e-3, measured 2.8e-5);
    the passes registered as the reference registers them, with SSR; no BVH
    and no ray is traced."""
    cfg = pcfg.RenderConfig(width=64, height=64, shadow_map_size=128,
                            hybrid=_settings(pcfg, False))
    r = prenderer.Renderer(pproc.cornell_box(), cfg, device="cpu")
    img = r.render_frame().numpy()
    golden = np.load(GOLDEN).astype(np.float32)
    err = float(np.sqrt(np.mean((np.clip(img, 0, 1) - np.clip(golden, 0, 1)) ** 2)))
    assert err <= 2e-3, err
    r.set_config(dataclasses.replace(cfg, hybrid=_settings(pcfg, True)))
    assert set(r.time_passes(iters=1)) == {
        "Geometry", "G-Buffer Pass", "Depth Prepass", "SSAO Pass", "SSAO Blur Pass",
        "SSR Pass", "Composition Pass"}
