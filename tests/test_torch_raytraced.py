"""The port's raytraced path against the JAX package's, the cornell golden
and the independent numpy oracle of ``tests/test_e2e_oracle.py``.

Both renderers draw the same scene arrays (``bridge.scene_from_numpy``) at
96x64: cornell with ``test_alpha`` off, ``checker_quad(alpha_leaf=True)``
with it on (both wavefronts through the alpha any-hit filter).  Tolerance:
1e-4 on >= 99.9% of pixels (the JAX side is jitted: XLA contracts
multiply-adds into FMAs, which may move a hit on a silhouette; measured:
every pixel within 1e-4 on both).  The golden and the oracle: RMSE <= 2e-3,
their own bar (measured 3.8e-5 against the golden, 1.8e-8 against the
oracle).
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_e2e_oracle import _oracle_render
from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
W, H = 96, 64
GOLDEN = Path(__file__).parent / "goldens" / "raytraced_cornell.npy"


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)))


@pytest.mark.parametrize("test_alpha", [False, True])
def test_frame_matches_jax(test_alpha):
    js = jproc.checker_quad(alpha_leaf=True) if test_alpha else jproc.cornell_box()
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8,
        raytraced=jcfg.RaytracedSettings(test_alpha=test_alpha)), path="raytraced")
    # the blue-noise stack rides along for user pipelines and no pass reads
    # it; generating it costs minutes on a CPU, so hand the renderer zeros
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(
        width=W, height=H, raytraced=pcfg.RaytracedSettings(test_alpha=test_alpha)),
        path="raytraced", device="cpu")
    j, p = np.asarray(jr.render_frame()), pr.render_frame().numpy()
    assert p.shape == j.shape == (4, H, W)
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    sky = np.all(p == np.float32([0.3, 0.8, 0.2, 1.0])[:, None, None], axis=0)
    assert 0.05 < sky.mean() < 0.95  # sky and geometry both in view
    if test_alpha:  # the filter shows: the unfiltered frame differs
        off = prenderer.Renderer(ps, pcfg.RenderConfig(width=W, height=H),
                                 path="raytraced", device="cpu").render_frame().numpy()
        assert np.abs(off - p).max() > 0.1


def test_cornell_golden():
    r = prenderer.Renderer(pproc.cornell_box(), pcfg.RenderConfig(width=64, height=64),
                           path="raytraced", device="cpu")
    img = r.render_frame().numpy()
    assert _rmse(img, np.load(GOLDEN).astype(np.float32)) <= 2e-3
    assert set(r.graph.find_execution_order()) == {
        "Geometry", "BVH", "Raytrace Pass", "Composition"}


def test_numpy_oracle():
    scene = pproc.cornell_box()
    ours = prenderer.Renderer(scene, pcfg.RenderConfig(width=64, height=64),
                              path="raytraced", device="cpu").render_frame().numpy()
    ref = _oracle_render(scene, 64, 64)
    diff = np.abs(ours - ref).max(axis=0)
    assert (diff > 0.05).mean() < 0.01
    assert float(np.sqrt(((ours - ref) ** 2).mean())) <= 2e-3
