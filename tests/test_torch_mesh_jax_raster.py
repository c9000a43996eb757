"""The port's raster-mode hybrid frame over a CPU mesh of 8 shards against
the JAX package's over 8 virtual CPU devices (``Renderer(..., mesh=
make_mesh(jax.devices("cpu")[:8]))``): rasterized shadows (the shadow-map
prepass and the 16-tap PCF), SSAO and its blur, SSR, on cornell_box at
96x64, frame 1 (frame 0's RNG seed is the same for every pixel).  The port
row-shards every image pass of the frame; the JAX package's GSPMD
partitions them.

Tolerance: test_torch_mesh_jax.py's, 1e-4 on >= 99.9% of pixels.
Measured with both on a CPU: every pixel within 1e-4 (max 1.8e-5).  ~30 s
alone, most of it the JAX frame's compile.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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


def raster_settings(m):
    return m.HybridSettings(
        shadow_mode=m.ShadowMode.RASTERIZED, ao_mode=m.AmbientOcclusionMode.SSAO,
        reflection_mode=m.ReflectionMode.SSR)


def test_raster_mode_mesh_frame_matches_jax_mesh_frame():
    js = jproc.cornell_box()
    devs = jax.devices("cpu")[:8]
    with jax.default_device(devs[0]):
        jr = jrenderer.Renderer(js, jcfg.RenderConfig(
            width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, shadow_map_size=128,
            hybrid=raster_settings(jcfg)), path="hybrid", mesh=jax_make_mesh(devs))
        # no pass reads the blue-noise stack; generating it takes minutes here
        jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
        j = [np.asarray(jr.render_frame()) for _ in range(2)][1]
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(
        width=W, height=H, shadow_map_size=128, hybrid=raster_settings(pcfg)),
        mesh=make_mesh([torch.device("cpu")] * 8))
    p = [pr.render_frame().numpy() for _ in range(2)][1]
    assert p.shape == j.shape == (4, H, W) and np.isfinite(p).all()
    err = np.abs(p - j).max(axis=0)
    print(f"max {err.max():.3g}, share within 1e-4 {(err <= 1e-4).mean():.6f}")
    assert (err <= 1e-4).mean() >= 0.999, ((err <= 1e-4).mean(), err.max())
    assert p[:3].std() > 0.01
