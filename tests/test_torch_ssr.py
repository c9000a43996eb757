"""The port's screen-space reflections and bilinear samplers against the JAX
package on the same G-buffer (the small Sponza proxy at 96x64) and the same
PerFrameData.

Tolerances: the samplers within 1e-6 (measured 0).  SSR: the hit flag equal
on >= 99.9% of pixels, and the color within 1e-4 on >= 99.9% (measured:
every flag equal, max |diff| 1.04e-4 on a bright hit).  A march step is a
hard compare of a distance difference against 0.3 and the thickness, so an
ulp of XLA's dot-based matrix products can flip a hit; XLA's pow / exp /
sqrt differ from libm's by an ulp in the shading.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.ops import filters as jfilt
from vulkanhybridrenderer_tpu.ops import ssr as jssr
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.models import hybrid as phybrid
from vulkanhybridrenderer_tpu_torch.ops import filters as pfilt
from vulkanhybridrenderer_tpu_torch.ops import ssr as pssr

from test_torch_ssao import H, W, sponza_gbuffer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sponza():
    return sponza_gbuffer()


def _uv(n=4096):
    """uv points inside, on and past the image's edges."""
    gen = np.random.default_rng(6)
    uv = gen.uniform(-0.1, 1.1, size=(n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [0.5 / W, 0.5 / H], [1 - 0.5 / W, 0.2], [0.3, 1], [1, 0],
              [-5, 0.5], [0.5, 7]]
    return uv


@pytest.mark.parametrize("channels", [0, 4])
def test_bilinear_sample_matches_jax(channels):
    gen = np.random.default_rng(9)
    shape = (H, W) if channels == 0 else (channels, H, W)
    img = gen.normal(size=shape).astype(np.float32)
    uv = _uv()
    j = np.asarray(jfilt.bilinear_sample(jnp.asarray(img), jnp.asarray(uv)))
    p = pfilt.bilinear_sample(torch.from_numpy(img), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)


def test_bilinear_quad_and_rows_match_jax():
    img = np.random.default_rng(10).normal(size=(H, W)).astype(np.float32)
    for rows in ("quad2x2_rows", "quad4_rows"):
        np.testing.assert_array_equal(getattr(pfilt, rows)(torch.from_numpy(img)).numpy(),
                                      np.asarray(getattr(jfilt, rows)(jnp.asarray(img))))
    uv = _uv()
    quad = jfilt.quad2x2_rows(jnp.asarray(img))
    j = np.asarray(jfilt.bilinear_quad(quad, H, W, jnp.asarray(uv)))
    p = pfilt.bilinear_quad(pfilt.quad2x2_rows(torch.from_numpy(img)), H, W,
                            torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)
    # the two samplers are not the same function past the edges
    both = pfilt.bilinear_sample(torch.from_numpy(img), torch.from_numpy(uv)).numpy()
    assert not np.array_equal(both, p)


def test_ssr_matches_jax(sponza):
    gb, pfds = sponza
    jpfd, ppfd = pfds(1)
    names = (phybrid.DEPTH, phybrid.NORMALS, phybrid.ALBEDO, phybrid.MOTION_MR)
    j = np.asarray(jssr.ssr(jpfd, *(jnp.asarray(gb[n]) for n in names), jcfg.SSRSettings()))
    p = pssr.ssr(ppfd, *(torch.from_numpy(gb[n]) for n in names), pcfg.SSRSettings()).numpy()
    assert p.shape == j.shape == (4, H, W) and np.isfinite(p).all()
    hit_equal = p[3] == j[3]
    assert hit_equal.mean() >= 0.999, hit_equal.mean()
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert 0.0 < p[3].mean() < 1.0  # some pixels hit, some miss
