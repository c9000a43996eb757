"""The port's standalone atlas sampler (ops/texture.py: sample_atlas_bilinear,
sample_or_factor) against the reference's, on the cases of
``tests/test_scene.py:33-65`` (a flat colour, bilinear interpolation between
two texels, the factor fallback) and on a packed atlas of several
textures with seeded texture ids (-1 among them) and uvs outside [0, 1).

Both atlases are built by each package's own ``build_atlas`` from the same
images (equal arrays).  Tolerance 1e-6, the reference under
``jax.disable_jit()`` (where it rounds each product as the port does):
measured equal.  ~3 s alone.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.ops import texture as jtex
from vulkanhybridrenderer_tpu.scene.atlas import build_atlas as jbuild_atlas
from vulkanhybridrenderer_tpu_torch.ops import texture as ptex
from vulkanhybridrenderer_tpu_torch.scene.atlas import build_atlas as pbuild_atlas

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)


def _atlases(images, srgb):
    j = jbuild_atlas(images, srgb)
    p = pbuild_atlas(images, srgb).to("cpu")
    for f in ("data", "uv_offset", "uv_scale"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)))
    return j, p


def _both(fn, j_atlas, p_atlas, *args):
    with jax.disable_jit():
        j = np.asarray(getattr(jtex, fn)(j_atlas, *map(jnp.asarray, args)))
    p = getattr(ptex, fn)(p_atlas, *map(torch.from_numpy, args)).numpy()
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j, **TOL)
    return p


def test_flat_color():
    img = np.zeros((8, 8, 4), np.uint8)
    img[..., 0] = 200
    img[..., 3] = 255
    j, p = _atlases([img], [False])
    out = _both("sample_atlas_bilinear", j, p, np.array([0, 0], np.int32),
                np.array([[0.5, 0.5], [0.1, 0.9]], np.float32))
    np.testing.assert_allclose(out[:, 0], 200 / 255.0, atol=1e-5)
    np.testing.assert_allclose(out[:, 1], 0.0, atol=1e-6)
    np.testing.assert_allclose(out[:, 3], 1.0, atol=1e-6)


def test_bilinear_interp():
    """A 2x1 texture, black then white: its centre samples 0.5."""
    img = np.zeros((1, 2, 4), np.float32)
    img[0, 1] = 1.0
    j, p = _atlases([img], [False])
    out = _both("sample_atlas_bilinear", j, p, np.array([0], np.int32),
                np.array([[0.5, 0.5]], np.float32))
    np.testing.assert_allclose(out[0, 0], 0.5, atol=1e-5)


def test_sample_or_factor_fallback():
    j, p = _atlases([], [])
    factor = np.array([[0.3, 0.4, 0.5, 1.0]], np.float32)
    out = _both("sample_or_factor", j, p, np.array([-1], np.int32),
                np.array([[0.2, 0.2]], np.float32), factor)
    np.testing.assert_allclose(out, factor, atol=1e-6)


@pytest.mark.parametrize("fn", ["sample_atlas_bilinear", "sample_or_factor"])
def test_packed_atlas_random(fn):
    """Three textures of different sizes (one sRGB), ids -1..2 and uvs in
    [-2, 3) over a (5, 9) grid of pixels."""
    rng = np.random.default_rng(12)
    images = [rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
              for h, w in ((8, 8), (5, 13), (16, 3))]
    j, p = _atlases(images, [True, False, False])
    tex = rng.integers(-1, 3, (5, 9)).astype(np.int32)
    uv = rng.uniform(-2, 3, (5, 9, 2)).astype(np.float32)
    args = (tex, uv) + ((rng.uniform(size=(5, 9, 4)).astype(np.float32),)
                        if fn == "sample_or_factor" else ())
    out = _both(fn, j, p, *args)
    assert out.shape == (5, 9, 4)
    if fn == "sample_atlas_bilinear":
        assert (out[tex < 0] == 1.0).all()  # the default fallback
