"""The Renderer's state against the JAX renderer's, through the calls
that render without presenting: ``fetch_resources`` (the reference's
``fetch_resource``) leaves the frame index alone, and ``time_passes`` lets
the previous view become the current camera's, as the reference's do.

Both renderers run cornell_box() with the full hybrid's settings (RT
shadows + RT AO + RT reflections + SVGF, alpha_raster="brute", 4 peel
rounds) at 32x24 from the same scene arrays; the JAX renderer gets zero
blue noise, as test_torch_hybrid.py hands it.  The frame index agrees
exactly after each call, the previous view and projection to 1e-6, and the
frames that follow within test_torch_hybrid_full.py's tolerance: 1e-4 on
>= 99.9% of pixels.  The two cases take ~45 s together alone, most of it
the reference's compiles (its time_passes jits every pass on its own).
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
W, H = 32, 24


def _full(m):
    return m.HybridSettings(
        shadow_mode=m.ShadowMode.RAYTRACED, ao_mode=m.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=m.ReflectionMode.RAYTRACED, denoise=True,
    )


def _renderers():
    js = jproc.cornell_box()
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, shadow_map_size=128,
        alpha_raster="brute", alpha_peel_rounds=4, ao_rays=2, hybrid=_full(jcfg),
    ), path="hybrid")
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(
        width=W, height=H, alpha_raster="brute", alpha_peel_rounds=4, ao_rays=2,
        hybrid=_full(pcfg)), device="cpu")
    return jr, pr


def _frames_agree(j, p):
    j, p = np.asarray(j), p.numpy()
    assert p.shape == j.shape == (4, H, W) and np.isfinite(p).all()
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01  # a real image, not a constant


def _same_prev_view(jr, pr):
    for a, b in ((jr._prev_view, pr._prev_view), (jr._prev_proj, pr._prev_proj)):
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                   rtol=0, atol=1e-6)


def test_fetch_resources_keeps_the_frame_index():
    jr, pr = _renderers()
    jr.render_frame()
    pr.render_frame()
    assert jr.frame_index == pr.frame_index == 1
    j_out = jr.fetch_resource("RENDER_OUTPUT")
    p_out = pr.fetch_resources("RENDER_OUTPUT")["RENDER_OUTPUT"]
    assert jr.frame_index == pr.frame_index == 1
    _frames_agree(j_out, p_out)
    j, p = jr.render_frame(), pr.render_frame()
    assert jr.frame_index == pr.frame_index == 2
    _frames_agree(j, p)


def test_time_passes_takes_the_current_view_as_previous():
    jr, pr = _renderers()
    jr.render_frame()
    pr.render_frame()
    for r in (jr, pr):
        r.update_camera(0.25, keys={"w", "d"}, mouse_delta=(40.0, -15.0), mouse_down=True)
    np.testing.assert_array_equal(pr.scene.camera.view(), np.asarray(jr.scene.camera.view()))
    before = pr._prev_view.copy()
    jr.time_passes(iters=1)
    pr.time_passes(iters=1)
    assert jr.frame_index == pr.frame_index == 1
    _same_prev_view(jr, pr)
    assert not np.array_equal(pr._prev_view, before)  # the camera moved
    j, p = jr.render_frame(), pr.render_frame()
    assert jr.frame_index == pr.frame_index == 2
    _same_prev_view(jr, pr)
    _frames_agree(j, p)
