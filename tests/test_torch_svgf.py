"""The port's SVGF (temporal reprojection, a-trous iterations, the whole
denoise with its carried state) against the JAX package over 3 frames of
seeded G-buffer and ray-traced inputs.

Tolerance 1e-5: both compute in float32 with the same operation order, and
differ only in exp / sqrt and XLA's fusion of multiply-adds.  The reference
runs jitted (op-by-op dispatch of its ~1,000 operations takes minutes).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.core import types as jtypes
from vulkanhybridrenderer_tpu.ops import filters as jfilters
from vulkanhybridrenderer_tpu.ops import svgf as jsvgf
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import filters as pfilters
from vulkanhybridrenderer_tpu_torch.ops import svgf as psvgf

# One thread: with two, about one process in twenty computed the lower half
# of an a-trous output differently (up to 1.6e-4 relative), past TOL.
torch.set_num_threads(1)
H, W = 40, 56
TOL = dict(rtol=1e-5, atol=1e-5)
j_atrous = jax.jit(jsvgf.atrous_iteration, static_argnums=2)
j_temporal = jax.jit(jsvgf.temporal)
j_denoise = jax.jit(jsvgf.denoise)


def _frames(n=3, seed=0):
    """n frames of (normal_oid, motion_mr, shadow_ao) (4, H, W) float32:
    four objects in vertical bands with noisy normals, sky (id 0, normal 0)
    in the top rows, motion of up to 2.3 pixels (out of the image at the
    borders), binary shadows and AO of 0, 0.5 or 1.  The motion keeps each
    reprojected position 0.2 pixel or more off the texel grid: there a
    bilinear weight nears 0 and the reference's acc_w > 1e-6 switch to the
    3x3 fallback could flip on one rounding, which XLA's FMA contraction
    does not reproduce."""
    rng = np.random.default_rng(seed)
    oid = np.minimum(np.arange(W) // 14, 3)[None, :].repeat(H, 0).astype(np.float32)
    base = rng.normal(size=(4, 3))
    out = []
    for _ in range(n):
        nrm = base[oid.astype(int)] + 0.3 * rng.normal(size=(H, W, 3))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        normal_oid = np.concatenate([nrm.transpose(2, 0, 1), oid[None]]).astype(np.float32)
        normal_oid[:, :3] = 0.0  # sky
        motion_mr = np.zeros((4, H, W), np.float32)
        for c, size in ((0, W), (1, H)):
            shift = rng.integers(-2, 3, (H, W)) + rng.uniform(-0.3, 0.3, (H, W))
            motion_mr[c] = shift / size
        motion_mr[2:] = rng.uniform(size=(2, H, W))
        shadow_ao = np.zeros((4, H, W), np.float32)
        shadow_ao[0] = rng.uniform(size=(H, W)) < 0.6
        shadow_ao[1] = rng.choice(np.float32([0.0, 0.5, 1.0]), (H, W))
        shadow_ao[3] = 1.0
        out.append((normal_oid, motion_mr, shadow_ao))
    return out


def _state_to_numpy(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_filters():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(3, H, W)).astype(np.float32)
    for dy, dx in ((0, 0), (2, -3), (-5, 7), (H + 1, 0), (0, -W - 4)):
        np.testing.assert_array_equal(pfilters.shifted(_t(img), dy, dx, fill=-2.0).numpy(),
                                      np.asarray(jfilters.shifted(jnp.asarray(img), dy, dx, fill=-2.0)))
    iy = rng.integers(-3, H + 3, (17, 5)).astype(np.int32)
    ix = rng.integers(-3, W + 3, (17, 5)).astype(np.int32)
    for a in (img, img[0]):
        np.testing.assert_array_equal(
            pfilters.gather_2d(_t(a), torch.from_numpy(iy), torch.from_numpy(ix)).numpy(),
            np.asarray(jfilters.gather_2d(jnp.asarray(a), jnp.asarray(iy), jnp.asarray(ix))))


@pytest.mark.parametrize("step", [1, 4, 16])
def test_atrous_iteration(step):
    normal_oid, _, shadow_ao = _frames(1, seed=2)[0]
    rng = np.random.default_rng(3)
    integrated = np.concatenate([shadow_ao[:2], rng.uniform(0, 0.3, (2, H, W))]).astype(np.float32)
    j = j_atrous(jnp.asarray(integrated), jnp.asarray(normal_oid), step)
    p = psvgf.atrous_iteration(_t(integrated), _t(normal_oid), step)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


def test_temporal_and_denoise_over_frames():
    """Each package carries its own state across 3 frames from the same
    empty history, handed to the port through the bridge; every frame's
    temporal stage, denoised output and new state agree."""
    js = jtypes.make_temporal_state(H, W)
    ps = bridge.temporal_state_from_numpy(**_state_to_numpy(js))
    for normal_oid, motion_mr, shadow_ao in _frames(3):
        jin = [jnp.asarray(a) for a in (normal_oid, motion_mr, shadow_ao)]
        pin = [_t(a) for a in (normal_oid, motion_mr, shadow_ao)]
        j_int, j_mom = j_temporal(*jin, js)
        p_int, p_mom = psvgf.temporal(*pin, ps)
        np.testing.assert_allclose(p_int.numpy(), np.asarray(j_int), **TOL)
        np.testing.assert_allclose(p_mom.numpy(), np.asarray(j_mom), **TOL)

        jd, js = j_denoise(*jin, js)
        pd, ps = psvgf.denoise(*pin, ps)
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TOL)
        for f, want in _state_to_numpy(js).items():
            np.testing.assert_allclose(getattr(ps, f).numpy(), want, err_msg=f, **TOL)
    # the history did reproject: frame 2 mixes in earlier frames
    assert (np.asarray(js.shadow_ao_history) != 0).any()
