"""The port's hybrid RT-shadows frame with ``shadow_accel="grid"`` (the
light-space shadow grid, K3's plain version on the CPU) against the JAX
renderer's grid frame, and against the port's own BVH8 frame.

Both renderers draw the same scene arrays (bridge.scene_from_numpy), the
small SponzaProxy of tests/test_hybrid_path.py:115-130 at 96x64, frames 0
and 1.  Tolerance against JAX: 1e-4 on >= 99.9% of pixels, the port's hybrid
tests' (XLA's fused multiply-adds and its own sin / cos may flip a shadow ray
grazing a silhouette).  Against the port's BVH frame: equal (torch.equal),
as the reference asserts array_equal: the grid only culls, the tests are the
same Moller-Trumbore.  With grid-only RT shadows the graph has no BVH pass.
"""
import dataclasses

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

torch.set_num_threads(2)
W, H = 96, 64


@pytest.fixture(scope="module")
def frames():
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=10, grid_res=6)
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, alpha_raster="off",
        shadow_map_size=128, shadow_accel="grid"), path="hybrid")
    # no pass reads the blue-noise stack, and generating it costs minutes
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    cfg = pcfg.RenderConfig(width=W, height=H, alpha_raster="off", shadow_map_size=128)
    grid = prenderer.Renderer(ps, dataclasses.replace(cfg, shadow_accel="grid"), device="cpu")
    bvh = prenderer.Renderer(ps, cfg, device="cpu")
    out = [(np.asarray(jr.render_frame()), grid.render_frame(), bvh.render_frame())
           for _ in range(2)]
    return out, grid, jr


@pytest.mark.parametrize("frame", [0, 1])
def test_grid_frame_matches_jax(frames, frame):
    j, p, _ = frames[0][frame]
    p = p.numpy()
    assert p.shape == j.shape == (4, H, W) and np.isfinite(p).all()
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01


@pytest.mark.parametrize("frame", [0, 1])
def test_grid_frame_equals_bvh_frame(frames, frame):
    _, grid, bvh = frames[0][frame]
    assert torch.equal(grid, bvh)


def test_grid_graph_has_no_bvh(frames):
    _, grid, jr = frames
    names = grid.list_resources()
    assert "ShadowGrid" in names and "BVH" not in names
    assert names == jr.list_resources()
    assert "Shadow Grid Build" in grid.graph.find_execution_order()
    sg = grid._get_shadow_grid()
    assert sg.overflow == 0 and sg.num_entries > 0
    assert grid._get_shadow_grid() is sg  # kept while the light stays
