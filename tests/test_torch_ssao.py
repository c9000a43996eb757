"""The port's SSAO and its blur against the JAX package on the same G-buffer
(the small Sponza proxy at 96x64) and the same PerFrameData.

Tolerances: SSAO within 1e-5 on >= 99.9% of pixels (measured: every pixel
within 6.1e-6) on frame 1; on frame 0 the reference's seed (y * H + x) * 0
gives every pixel the same 16 samples, kept, and held the same way
(measured 1.1e-6).  XLA's and libm's sin / cos differ by an ulp, which moves
a sample's texel coordinate slightly.  The blur within 1e-6 (measured 0:
the same 169 adds in the same order).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.core import types as jtypes
from vulkanhybridrenderer_tpu.ops import filters as jfilt
from vulkanhybridrenderer_tpu.ops import ssao as jssao
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu.utils import math3d as jm3
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.core import types as ptypes
from vulkanhybridrenderer_tpu_torch.models import hybrid as phybrid
from vulkanhybridrenderer_tpu_torch.ops import filters as pfilt
from vulkanhybridrenderer_tpu_torch.ops import ssao as pssao
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.utils import math3d as pm3

torch.set_num_threads(2)
W, H = 96, 64
GBUF = (phybrid.ALBEDO, phybrid.NORMALS, phybrid.MOTION_MR, phybrid.DEPTH)


def sponza_gbuffer():
    """The small Sponza proxy's G-buffer from the port (numpy), and a
    function making the matching (JAX, port) PerFrameData of a frame."""
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    r = prenderer.Renderer(ps, pcfg.RenderConfig(width=W, height=H, alpha_raster="brute"),
                           device="cpu")
    gb = {k: v.numpy() for k, v in r.fetch_resources(*GBUF).items()}
    view, proj = js.camera.view(), js.camera.projection(W / H)

    def pfds(frame):
        return (jtypes.make_per_frame_data(view, proj, js.light, W, H, frame),
                ptypes.make_per_frame_data(view, proj, ps.light, W, H, frame))
    return gb, pfds


@pytest.fixture(scope="module")
def sponza():
    return sponza_gbuffer()


@pytest.mark.parametrize("frame", [0, 1])
def test_ssao_matches_jax(sponza, frame):
    gb, pfds = sponza
    jpfd, ppfd = pfds(frame)
    depth, normals = gb[phybrid.DEPTH], gb[phybrid.NORMALS]
    j = np.asarray(jssao.ssao(jpfd, jnp.asarray(depth), jnp.asarray(normals), radius=0.75))
    p = pssao.ssao(ppfd, torch.from_numpy(depth), torch.from_numpy(normals), radius=0.75).numpy()
    assert p.shape == (H, W) and np.isfinite(p).all()
    close = np.abs(p - j) <= 1e-5
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert (p[depth > 0] < 1.0).any() and (p[depth == 0] == 0.0).all()


def test_ssao_blur_matches_jax():
    ao = np.random.default_rng(8).uniform(size=(H, W)).astype(np.float32)
    # jitted: eagerly each of the 169 shifts would compile a pad of its own
    j = np.asarray(jax.jit(jssao.ssao_blur)(jnp.asarray(ao)))
    p = pssao.ssao_blur(torch.from_numpy(ao)).numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)
    # the reference's edge darkening: a corner sums 7 x 7 in-bounds taps of
    # a constant image and still divides by 169
    ones = pssao.ssao_blur(torch.ones((H, W))).numpy()
    np.testing.assert_allclose(ones[0, 0], 49 / 169, rtol=1e-6)
    np.testing.assert_allclose(ones[H // 2, W // 2], 1.0, rtol=1e-6)


def test_transform_directions_matches_jax():
    gen = np.random.default_rng(3)
    m = gen.normal(size=(4, 4)).astype(np.float32)
    d = gen.normal(size=(7, 5, 3)).astype(np.float32)
    j = np.asarray(jm3.transform_directions(jnp.asarray(m), jnp.asarray(d)))
    p = pm3.transform_directions(torch.from_numpy(m), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pm3.SHADOW_BIAS_MATRIX, jm3.SHADOW_BIAS_MATRIX)


@pytest.mark.parametrize("dy,dx", [(0, 0), (-3, 2), (5, -7), (70, 0)])
def test_inbounds_mask_matches_jax(dy, dx):
    j = np.asarray(jfilt.inbounds_mask(H, W, dy, dx))
    p = pfilt.inbounds_mask(H, W, dy, dx).numpy()
    np.testing.assert_array_equal(p, j)
