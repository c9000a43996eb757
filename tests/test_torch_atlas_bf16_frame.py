"""A hybrid frame on a bf16 texture atlas against the JAX renderer's.

The small SponzaProxy built with atlas_dtype bf16 by the JAX package, its
arrays carried to the port by ``bridge.scene_from_numpy`` (the atlas as
bf16), rendered by both at 96x64 in the full hybrid configuration (RT
shadows, AO, reflections, SVGF) with the binned alpha depth-peel
(alpha_raster="brute", 4 rounds) over its alpha-masked textured foliage,
frames 0 and 1.  Every sampler and the alpha filter read the bf16 atlas
through float32 tables (shadetab.build_shade_tables' atlas_q,
texture.sample_atlas_bilinear), in both packages.  Tolerance: the frame
tests' 1e-4 on >= 99.9% of pixels (XLA's contracted multiply-adds and
its sin / cos).  ~40 s alone, most of it the reference's compile.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer

torch.set_num_threads(2)
W, H = 96, 64


def _full(m):
    return m.HybridSettings(
        shadow_mode=m.ShadowMode.RAYTRACED, ao_mode=m.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=m.ReflectionMode.RAYTRACED, denoise=True)


@pytest.fixture(scope="module")
def frames():
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8,
                            atlas_dtype=jnp.bfloat16)
    assert js.buffers.atlas.data.dtype == jnp.bfloat16 and js.buffers.has_alpha_mask
    kw = dict(width=W, height=H, shadow_map_size=128, alpha_raster="brute",
              alpha_peel_rounds=4, ao_rays=2)
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(hybrid=_full(jcfg), **kw), path="hybrid")
    # no pass reads the blue-noise stack; generating it takes minutes on a CPU
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(hybrid=_full(pcfg), **kw), device="cpu")
    assert pr.buffers.atlas.data.dtype == torch.bfloat16
    return [(np.asarray(jr.render_frame()), pr.render_frame().numpy()) for _ in range(2)]


@pytest.mark.parametrize("frame", [0, 1])
def test_bf16_atlas_frame_matches_jax(frames, frame):
    j, p = frames[frame]
    assert p.shape == j.shape == (4, H, W)
    assert np.isfinite(p).all()
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01  # a real image, not a constant
