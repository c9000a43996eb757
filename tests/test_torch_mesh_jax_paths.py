"""The port's raytraced and rayquery frames over a CPU mesh of 8 shards
against the JAX package's over 8 virtual CPU devices (``Renderer(...,
mesh=make_mesh(jax.devices("cpu")[:8]))``), at 96x64 on
``checker_quad(alpha_leaf=True)``: the raytraced frame with ``test_alpha``
(both wavefronts through the alpha any-hit filter, each shard tracing its
slab's rays), and the rayquery frame (the sort-last raster, then each shard
resolving, tracing and shading its band).  Frame 1, the camera moved.

Tolerance: test_torch_mesh_jax.py's, 1e-4 on >= 99.9% of pixels (the JAX
side is jitted: XLA contracts multiply-adds into FMAs).  Measured with both
on a CPU: every pixel within 1e-4, max 6.0e-8 on both frames.  ~25 s
alone, most of it the JAX frames' compile.  The port's mesh frames equal its single-device frames
(test_torch_mesh_frame.py, test_torch_mesh_paths.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.parallel.mesh import make_mesh
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer

torch.set_num_threads(2)
W, H = 96, 64


def _settings(m, path):
    return {"raytraced": {"raytraced": m.RaytracedSettings(test_alpha=True)},
            "rayquery": {}}[path]


@pytest.mark.parametrize("path", ["raytraced", "rayquery"])
def test_mesh_path_matches_jax_mesh_frame(path):
    js = jproc.checker_quad(alpha_leaf=True)
    # the scene's arrays before the JAX renderer moves its camera
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    devs = jax.devices("cpu")[:8]
    with jax.default_device(devs[0]):
        jr = jrenderer.Renderer(js, jcfg.RenderConfig(
            width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, **_settings(jcfg, path)),
            path=path, mesh=jax_make_mesh(devs))
        # no pass reads the blue-noise stack; generating it takes minutes here
        jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
        jr.render_frame()
        jr.update_camera(0.05, keys={"d"})
        j = np.asarray(jr.render_frame())
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(width=W, height=H, **_settings(pcfg, path)),
                            path=path, mesh=make_mesh([torch.device("cpu")] * 8))
    pr.render_frame()
    pr.update_camera(0.05, keys={"d"})
    p = pr.render_frame().numpy()
    assert p.shape == j.shape == (4, H, W) and np.isfinite(p).all()
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01
