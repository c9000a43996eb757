"""The port's rayquery path (K1a raster, forward resolve, one unfiltered
any-hit shadow ray per pixel) against the JAX package's, and the checker
golden.

Both renderers draw the same scene arrays at 96x64: the small SponzaProxy,
whose masked leaves raster solid here as in the reference (no alpha kill in
the rayquery fragment shader).  Tolerance: 1e-4 on >= 99.9% of pixels (the
JAX side is jitted, and XLA's FMA-contracted triangle setup moves coverage
on a few edge pixels; measured: 1.0 within 1e-4).  The golden: RMSE <= 2e-3
(measured 2.2e-5).
"""
import dataclasses
from pathlib import Path

import numpy as np
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.ops import traverse
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
W, H = 96, 64
GOLDEN = Path(__file__).parent / "goldens" / "rayquery_checker.npy"


def test_frame_matches_jax():
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    # shadow_map_size: the reference checks the map's binning at first frame
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(width=W, height=H, bvh_dtype="f32",
                                                  bvh_leaf_max=8, shadow_map_size=128),
                            path="rayquery")
    # no pass reads the blue-noise stack; generating it costs minutes here
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(width=W, height=H), path="rayquery",
                            device="cpu")
    j, p = np.asarray(jr.render_frame()), pr.render_frame().numpy()
    assert p.shape == j.shape == (4, H, W)
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01


def test_checker_golden_and_passes():
    before = dict(traverse.trace.launches)
    r = prenderer.Renderer(pproc.checker_quad(), pcfg.RenderConfig(width=64, height=64),
                           path="rayquery", device="cpu")
    img = r.render_frame().numpy()
    golden = np.load(GOLDEN).astype(np.float32)
    err = float(np.sqrt(np.mean((np.clip(img, 0, 1) - np.clip(golden, 0, 1)) ** 2)))
    assert err <= 2e-3, err
    assert set(r.graph.find_execution_order()) == {"Geometry", "BVH", "Rayquery Pass"}
    assert dict(traverse.trace.launches) == before  # no kernel launch on the CPU
