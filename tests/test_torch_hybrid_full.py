"""The port's full hybrid frame (RT shadows + RT AO + RT reflections + SVGF,
alpha_raster="brute" with 4 peel rounds) against the JAX renderer, frames
0, 1 and 2 with the temporal state carried; and the port's
hybrid_full_cornell golden.

Both packages render from the same scene arrays (bridge.scene_from_numpy) at
96x64.  Tolerance: 1e-4 on >= 99.9% of pixels.  Measured with both on a
CPU: every pixel within 1e-5 (max 5.6e-6 on cornell, 7.8e-6 on the small
Sponza proxy).  The slack is for a shadow or AO ray grazing a silhouette,
which can flip between XLA (its own sin / cos, fused multiply-adds) and the
port, and which SVGF then spreads over its neighbourhood.
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
FRAMES = 3
GOLDEN = Path(__file__).parent / "goldens" / "hybrid_full_cornell.npy"


def full_settings(m):
    return m.HybridSettings(
        shadow_mode=m.ShadowMode.RAYTRACED, ao_mode=m.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=m.ReflectionMode.RAYTRACED, denoise=True,
    )


def render_both(js):
    """FRAMES frames of the full configuration from the JAX renderer and the
    port (on the CPU), from the same scene arrays."""
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, shadow_map_size=128,
        alpha_raster="brute", alpha_peel_rounds=4, ao_rays=2, hybrid=full_settings(jcfg),
    ), path="hybrid")
    # the blue-noise stack rides along for user pipelines and no pass reads
    # it; generating it costs minutes on a CPU, so hand the renderer zeros
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(
        width=W, height=H, alpha_raster="brute", alpha_peel_rounds=4, ao_rays=2,
        hybrid=full_settings(pcfg)), device="cpu")
    return [(np.asarray(jr.render_frame()), pr.render_frame().numpy()) for _ in range(FRAMES)]


def check_frame(frames, frame):
    j, p = frames[frame]
    assert p.shape == j.shape == (4, H, W)
    assert np.isfinite(p).all()
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01  # a real image, not a constant


@pytest.fixture(scope="module")
def cornell_frames():
    return render_both(jproc.cornell_box())


@pytest.mark.parametrize("frame", range(FRAMES))
def test_full_frame_matches_jax_cornell(cornell_frames, frame):
    check_frame(cornell_frames, frame)


def test_full_cornell_golden():
    """tests/goldens/hybrid_full_cornell.npy (the JAX package's golden of
    this configuration at 64x64 after 2 frames), RMSE <= 2e-3 after
    clamping, as test_goldens.py holds the reference to it."""
    r = prenderer.Renderer(pproc.cornell_box(), pcfg.RenderConfig(
        width=64, height=64, hybrid=full_settings(pcfg)), device="cpu")
    for _ in range(2):
        img = r.render_frame().numpy()
    golden = np.load(GOLDEN).astype(np.float32)
    err = float(np.sqrt(np.mean((np.clip(img, 0, 1) - np.clip(golden, 0, 1)) ** 2)))
    assert err <= 2e-3, err
    assert r.temporal_state.prev_normal_oid.shape == (4, 64, 64)


def test_temporal_state_carried():
    """The renderer makes the SVGF history at construction, replaces it
    after each rendered frame, keeps it through time_passes and
    fetch_resources (as the reference's renderer does), keeps it through a
    set_config of the same size and makes it anew on a resize."""
    cfg = pcfg.RenderConfig(width=32, height=24, hybrid=full_settings(pcfg))
    r = prenderer.Renderer(pproc.cornell_box(), cfg, device="cpu")
    empty = r.temporal_state
    assert r.path.uses_temporal_state
    assert (empty.prev_normal_oid == -1).all() and (empty.shadow_ao_history == 0).all()
    r.render_frame()
    after = r.temporal_state
    assert after is not empty and (after.prev_normal_oid != -1).any()
    r.time_passes(iters=1)
    r.fetch_resources("RENDER_OUTPUT")
    assert r.temporal_state is after
    r.set_config(dataclasses.replace(cfg, ao_rays=1))
    assert r.temporal_state is after
    r.set_config(dataclasses.replace(cfg, width=40))
    assert r.temporal_state.moments_history.shape == (4, 24, 40)
    assert (r.temporal_state.moments_history == 0).all()
    assert r.render_frame().shape == (4, 24, 40)
    off = prenderer.Renderer(pproc.cornell_box(), pcfg.RenderConfig(width=32, height=24),
                             device="cpu")
    assert not off.path.uses_temporal_state
