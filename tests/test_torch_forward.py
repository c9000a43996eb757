"""The port's forward raster path against the JAX Renderer(path="forward"):
one sample, coverage MSAA 4x and supersample 4x on the cornell box at 96x64,
frames 0 and 1 (shadow_map_size 128).

Tolerance: 1e-4 on >= 99.9% of pixels (measured: every pixel within 1.2e-7).
The coverage-MSAA frame of the small Sponza proxy, with its alpha-masked
leaves peeled per sample, is test_torch_forward_sponza.py.
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
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as prt
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
W, H = 96, 64
GOLDEN = Path(__file__).parent / "goldens" / "forward_cornell.npy"
MODES = {"1x": (1, "coverage"), "coverage4x": (4, "coverage"),
         "supersample4x": (4, "supersample")}


def forward_frames(js, mode, frames=2, tol=1e-4, share=0.999):
    """Render `frames` frames of the JAX scene `js` in forward `mode` with
    both renderers (the port from the same scene arrays) and hold each pair
    to `tol` on >= `share` of pixels; returns the port's frames."""
    samples, msaa_mode = MODES[mode]
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, shadow_map_size=128,
        forward=jcfg.ForwardSettings(samples, msaa_mode)), path="forward")
    # the blue-noise stack rides along for user pipelines and no pass reads
    # it; generating it costs minutes on a CPU, so hand the renderer zeros
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(
        width=W, height=H, shadow_map_size=128,
        forward=pcfg.ForwardSettings(samples, msaa_mode)), path="forward", device="cpu")
    out = []
    for _ in range(frames):
        j, p = np.asarray(jr.render_frame()), pr.render_frame().numpy()
        assert p.shape == j.shape == (4, H, W)
        assert np.isfinite(p).all()
        close = np.abs(p - j).max(axis=0) <= tol
        assert close.mean() >= share, (close.mean(), np.abs(p - j).max())
        assert p[:3].std() > 0.01  # a real image, not a constant
        out.append(p)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_matches_jax(mode):
    forward_frames(jproc.cornell_box(), mode)


def _port_frame(**forward):
    r = prenderer.Renderer(pproc.cornell_box(), pcfg.RenderConfig(
        width=W, height=H, shadow_map_size=128,
        forward=pcfg.ForwardSettings(**forward)), path="forward", device="cpu")
    return r.render_frame()


def test_coverage_msaa_semantics():
    """Interior pixels keep the one-sample color (same fragment, shaded
    once); a few edge pixels change, toward the supersampled image."""
    base = _port_frame()
    cov = _port_frame(msaa_samples=4)
    ss = _port_frame(msaa_samples=4, msaa_mode="supersample")
    differs = ~torch.isclose(cov, base, atol=1e-5).all(dim=0)
    assert 0.0 < float(differs.float().mean()) < 0.15
    assert float((cov - ss).abs().mean()) < 0.01


@pytest.mark.parametrize("samples,mode", [(2, "coverage"), (8, "coverage"),
                                          (2, "supersample"), (8, "supersample")])
def test_other_sample_counts_render(samples, mode):
    """2 and 8 samples in both modes: finite, the frame's size, and within
    the same edge band of the one-sample frame (supersample k=2 is the
    one-sample frame: isqrt(2) = 1)."""
    base = _port_frame()
    img = _port_frame(msaa_samples=samples, msaa_mode=mode)
    assert img.shape == (4, H, W) and bool(torch.isfinite(img).all())
    differs = float((~torch.isclose(img, base, atol=1e-5).all(dim=0)).float().mean())
    if (samples, mode) == (2, "supersample"):
        assert differs == 0.0
    else:
        assert 0.0 < differs < 0.15


def test_forward_golden_and_passes():
    """The reference's golden (64x64, RMSE <= 2e-3, measured 5.9e-5), and the
    pass table: the Depth Prepass runs though the Forward Pass's shader
    ignores the shadow map, as in the reference."""
    r = prenderer.Renderer(pproc.cornell_box(), pcfg.RenderConfig(
        width=64, height=64, shadow_map_size=128), path="forward", device="cpu")
    img = r.render_frame().numpy()
    golden = np.load(GOLDEN).astype(np.float32)
    err = float(np.sqrt(np.mean((np.clip(img, 0, 1) - np.clip(golden, 0, 1)) ** 2)))
    assert err <= 2e-3, err
    assert set(r.time_passes(iters=1)) == {"Geometry", "Depth Prepass", "Forward Pass"}
    sm = r.fetch_resources("Shadow Map")["Shadow Map"]
    assert sm.shape == (128, 128) and float(sm.max()) > 0.0


def test_forward_msaa_launches_no_kernel_on_cpu():
    before = (prt.raster_tiles.launches, prt.raster_tiles_msaa.launches)
    _port_frame(msaa_samples=4)
    assert (prt.raster_tiles.launches, prt.raster_tiles_msaa.launches) == before
