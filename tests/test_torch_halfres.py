"""Half-resolution RT (ops/upsample.py, HybridSettings.rt_scale) against the
JAX package's.

The pieces on seeded inputs: ``downsample_nearest``, ``_tap_indices`` and
``joint_bilateral_upsample`` at scales 2 and 3, on even and odd sizes.
Tolerances: the downsample and the tap indices exactly equal (measured
equal); the upsample within 1e-6 absolute (measured <= 1.2e-7: XLA fuses the
weight products differently).

The frame at rt_scale=2, the port on the CPU and the JAX renderer from the
same scene arrays (bridge.scene_from_numpy) on the small SponzaProxy: here
the odd 95x63 with RT shadows (the traced grid 48x32 does not divide it),
test_torch_halfres_full.py the even 96x64 with the full RT set.  Tolerance:
1e-4 on >= 99.9% of pixels, the full frame's gate of test_torch_hybrid_full.py
(measured: 0.99950 within 1e-4, the other 3 pixels where a shadow ray grazes
a silhouette and flips between XLA's fused multiply-adds and the port).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.ops import upsample as jup
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.ops import upsample as pup
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer

torch.set_num_threads(2)


def _gbuffer(rng, h, w):
    """A seeded full-resolution G-buffer with a few objects (so some taps fail
    the id test) and unit normals."""
    depth = rng.uniform(0.05, 1.0, (h, w)).astype(np.float32)
    n = rng.normal(size=(3, h, w)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    n[:, : h // 2] = np.float32([0.0, 1.0, 0.0])[:, None, None]  # a flat region
    oid = rng.integers(0, 3, (1, h, w)).astype(np.float32)
    oid[:, : h // 2] = 1.0
    return depth, np.concatenate([n, oid]).astype(np.float32)


@pytest.mark.parametrize("scale,h,w", [(2, 16, 24), (2, 15, 23), (3, 17, 20)])
def test_pieces_match_jax(scale, h, w):
    rng = np.random.default_rng(11)
    img = rng.normal(size=(4, h, w)).astype(np.float32)
    np.testing.assert_array_equal(pup.downsample_nearest(torch.from_numpy(img), scale).numpy(),
                                  np.asarray(jup.downsample_nearest(jnp.asarray(img), scale)))
    hs = -(-h // scale)
    for a, b in zip(pup._tap_indices(h, hs, scale), jup._tap_indices(h, hs, scale)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    depth, no = _gbuffer(rng, h, w)
    d_lo, no_lo = depth[::scale, ::scale], no[:, ::scale, ::scale]
    lo = rng.uniform(0, 1, (4,) + d_lo.shape).astype(np.float32)
    args = (lo, scale, depth, no, d_lo, no_lo)
    got = pup.joint_bilateral_upsample(
        *(torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
          for a in args)).numpy()
    ref = np.asarray(jup.joint_bilateral_upsample(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)))
    assert got.shape == (4, h, w)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.std() > 0.05  # a real signal


def _settings(m, full):
    if not full:
        return m.HybridSettings(rt_scale=2)
    return m.HybridSettings(
        shadow_mode=m.ShadowMode.RAYTRACED, ao_mode=m.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=m.ReflectionMode.RAYTRACED, denoise=True, rt_scale=2)


def render_both(w, h, full, n_frames):
    """n_frames frames at rt_scale=2 of the small SponzaProxy from the JAX
    renderer and the port (on the CPU), from the same scene arrays; and the
    port's renderer."""
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        width=w, height=h, bvh_dtype="f32", bvh_leaf_max=8, shadow_map_size=128,
        alpha_raster="off", ao_rays=2, hybrid=_settings(jcfg, full)), path="hybrid")
    # the blue-noise stack rides along for user pipelines and no pass reads
    # it; generating it costs minutes on a CPU, so hand the renderer zeros
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(
        width=w, height=h, alpha_raster="off", ao_rays=2, hybrid=_settings(pcfg, full)),
        device="cpu")
    assert pr.temporal_state.shadow_ao_history.shape[-2:] == (-(-h // 2), -(-w // 2))
    return [(np.asarray(jr.render_frame()), pr.render_frame().numpy())
            for _ in range(n_frames)], pr


def check_frames(out, pr, h, w):
    for j, p in out:
        assert p.shape == j.shape == (4, h, w)
        assert np.isfinite(p).all()
        close = np.abs(p - j).max(axis=0) <= 1e-4
        assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
        assert p[:3].std() > 0.01
    order = pr.graph.find_execution_order()
    assert order.index("RT Downsample Pass") < order.index("Raytrace Pass") \
        < order.index("RT Upsample Pass") < order.index("Composition Pass")


def test_odd_frame_matches_jax():
    out, pr = render_both(95, 63, full=False, n_frames=1)
    check_frames(out, pr, 63, 95)
