"""Animated scenes in the port: pica_proxy / animate_pica against the JAX
package's, and the animated raytraced and hybrid frames (BVH8 refit every
frame; the hybrid one with the shadow grid rebuilt every frame) against the
JAX renderer over 2 animated frames; the app's ``--animate --scene pica``.

Both renderers draw the same scene arrays at 96x64 with
``animate(animate_pica(scene, i / 4))`` before frame i (a step of 1/60 s
moves pica_proxy(grid=2)'s boxes across no pixel centre at this size).  Tolerance: 1e-4
on >= 99.9% of pixels, the port's frame tests' (XLA's fused multiply-adds
and its own sin / cos may flip a ray grazing a silhouette).
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
from vulkanhybridrenderer_tpu_torch.runtime import app
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc
from vulkanhybridrenderer_tpu_torch.utils import png

torch.set_num_threads(2)
W, H = 96, 64


def _full(m):
    return m.HybridSettings(
        shadow_mode=m.ShadowMode.RAYTRACED, ao_mode=m.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=m.ReflectionMode.RAYTRACED, denoise=True)


def test_pica_scene_and_transforms_match():
    js, ps = jproc.pica_proxy(grid=6), pproc.pica_proxy(grid=6)
    assert ps.name == js.name == "PicaProxy"
    jb, pb = dataclasses.asdict(js.buffers), dataclasses.asdict(ps.buffers)
    for k, v in jb.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                np.testing.assert_array_equal(np.asarray(pb[k][kk]), np.asarray(vv), f"{k}.{kk}")
        else:
            np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(v), k)
    for t in (0.0, 1 / 60, 0.5, 3.0):
        p = pproc.animate_pica(ps, t)
        assert isinstance(p, np.ndarray) and p.dtype == np.float32 and p.shape == (37, 4, 4)
        np.testing.assert_array_equal(p, np.asarray(jproc.animate_pica(js, t)))
    assert not np.array_equal(pproc.animate_pica(ps, 0.5), pproc.animate_pica(ps, 0.0))


@pytest.mark.parametrize("path", ["raytraced", "hybrid"])
def test_animated_frames_match_jax(path):
    """Two animated frames; the hybrid one in the full configuration with
    shadow_accel="grid" (BVH Refit for AO and reflections, the Shadow Grid
    Build pass rebuilt in-frame for the shadows)."""
    js = jproc.pica_proxy(grid=2)
    kw = dict(width=W, height=H, animated=True, shadow_map_size=128)
    if path == "hybrid":
        kw.update(shadow_accel="grid")
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        bvh_dtype="f32", bvh_leaf_max=8, **kw,
        **({"hybrid": _full(jcfg)} if path == "hybrid" else {})), path=path)
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)  # no pass reads it
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(
        **kw, **({"hybrid": _full(pcfg)} if path == "hybrid" else {})), path=path, device="cpu")
    names = pr.list_resources()
    assert "BVH" in names and ("ShadowGrid" in names) == (path == "hybrid")
    order = pr.graph.find_execution_order()
    assert "BVH Refit" in order and ("Shadow Grid Build" in order) == (path == "hybrid")
    prev = None
    for i in range(2):
        jr.animate(jproc.animate_pica(js, i / 4.0))
        pr.animate(pproc.animate_pica(ps, i / 4.0))
        j, p = np.asarray(jr.render_frame()), pr.render_frame().numpy()
        assert p.shape == j.shape == (4, H, W) and np.isfinite(p).all()
        close = np.abs(p - j).max(axis=0) <= 1e-4
        assert close.mean() >= 0.999, (i, close.mean(), np.abs(p - j).max())
        if prev is not None:
            assert np.abs(p - prev).max() > 1e-3  # the boxes moved
        prev = p
    assert pr.prim_transform.device.type == "cpu"


def test_app_animates_pica(tmp_path, capsys):
    out = tmp_path / "pica.png"
    assert app.main(["--scene", "pica", "--animate", "--width", "48", "--height", "32",
                     "--frames", "2", "--device", "cpu", "--reflections", "raytraced",
                     "--out", str(out)]) == 0
    assert png.decode_png(out.read_bytes()).shape == (32, 48, 4)
    assert "2 frame(s)" in capsys.readouterr().out
