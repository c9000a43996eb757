"""The port's fused frame against the JAX package's: Renderer(dispatch=
"fused") on both, cornell_box() at 96x64, RT shadows + RT AO + SVGF,
frames 0, 1 and 2 with the temporal state carried.

Both packages render from the same scene arrays (bridge.scene_from_numpy).
Tolerance (ROADMAP section 3's fused multiply-add divergence): 1e-4 on
>= 99.9% of pixels.  XLA contracts multiply-adds into FMAs and uses its own
sin / cos, so an AO or shadow ray grazing a silhouette can flip, and SVGF
spreads it over its neighbourhood; everything else agrees to ~1e-5.
"""
import dataclasses

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

torch.set_num_threads(2)
W, H = 96, 64
FRAMES = 3


def _settings(m):
    return m.HybridSettings(shadow_mode=m.ShadowMode.RAYTRACED,
                            ao_mode=m.AmbientOcclusionMode.RAYTRACED, denoise=True)


@pytest.fixture(scope="module")
def frames():
    js = jproc.cornell_box()
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, shadow_map_size=128,
        alpha_raster="off", hybrid=_settings(jcfg)), path="hybrid", dispatch="fused")
    # the blue-noise stack rides along for user pipelines and no pass reads
    # it; generating it costs minutes on a CPU, so hand the renderer zeros
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(
        width=W, height=H, shadow_map_size=128, alpha_raster="off", hybrid=_settings(pcfg)),
        path="hybrid", dispatch="fused", device="cpu")
    return [(np.asarray(jr.render_frame()), pr.render_frame().numpy()) for _ in range(FRAMES)]


@pytest.mark.parametrize("frame", range(FRAMES))
def test_fused_frame_matches_jax(frames, frame):
    j, p = frames[frame]
    assert p.shape == j.shape == (4, H, W)
    assert np.isfinite(p).all()
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01  # a real image, not a constant
    if frame:
        assert not np.array_equal(p, frames[frame - 1][1])  # history and noise moved
