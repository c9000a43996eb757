"""The renderer without a native build, against the JAX renderer's.

``native_bridge.native_available()`` returns False, without raising, when
g++ is missing or the build fails (both made to happen by monkeypatching;
nothing on disk changes).  With both packages' ``native_available``
monkeypatched to False, each renderer's ``_get_bvh`` takes the device LBVH
(leaf size 1) collapsed on the host: the port's in Python (its native
loader patched to raise, so nothing native runs), the reference's as it
does.  The two BVH8 tables are equal, and the hybrid RT-shadows frames of
cornell_box() at 96x64 (frames 0 and 1) agree within test_torch_hybrid.py's
tolerance: 1e-4 on >= 99.9% of pixels (XLA's fused multiply-adds).  The
JAX renderer gets zero blue noise, as test_torch_hybrid.py hands it.  ~30 s
alone, most of it the reference's compile.
"""
import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu import native_bridge as jnative
from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch import native_bridge as pnative
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.utils import build

torch.set_num_threads(2)
W, H = 96, 64


def _failing_build(*args, **kwargs):
    raise RuntimeError("building vhr_native failed (made to fail by the test)")


@pytest.mark.parametrize("how", ["no g++", "failed build"])
def test_native_available_false_without_raising(monkeypatch, how):
    if how == "no g++":
        monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    else:
        monkeypatch.setattr(build, "build_library", _failing_build)
    pnative.native_available.cache_clear()
    pnative.load.cache_clear()
    try:
        assert pnative.native_available() is False
        assert pnative.native_available() is False  # the kept answer
        if how == "failed build":
            with pytest.raises(RuntimeError, match="made to fail"):
                pnative.load()  # load() still raises for callers that need it
    finally:
        pnative.native_available.cache_clear()
        pnative.load.cache_clear()


def _no_native_load():
    raise AssertionError("the native library was asked for on the no-native route")


@pytest.fixture(scope="module")
def no_native():
    """Frames 0 and 1 and the BVH8 of both renderers, each built with its
    package's native_available returning False."""
    js = jproc.cornell_box()
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "native_available", lambda: False)
        mp.setattr(pnative, "native_available", lambda: False)
        mp.setattr(pnative, "load", _no_native_load)
        jr = jrenderer.Renderer(js, jcfg.RenderConfig(
            width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, alpha_raster="off",
            shadow_map_size=128), path="hybrid")
        jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
        pr = prenderer.Renderer(ps, pcfg.RenderConfig(width=W, height=H, alpha_raster="off"),
                                device="cpu")
        frames = [(np.asarray(jr.render_frame()), pr.render_frame().numpy()) for _ in range(2)]
    return frames, jr._get_bvh(), pr._get_bvh(), ps


def test_fallback_bvh8_equals_reference(no_native):
    _, j, p, ps = no_native
    for f in ("rows", "child8", "valid8", "tri8"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert p.depth == j.depth
    # the route's tree, not the SAH tree a renderer with the native build takes
    sah = prenderer.Renderer(ps, pcfg.RenderConfig(width=W, height=H), device="cpu")._get_bvh()
    assert pnative.native_available() and not torch.equal(sah.rows, p.rows)


@pytest.mark.parametrize("frame", [0, 1])
def test_fallback_frame_matches_reference(no_native, frame):
    j, p = no_native[0][frame]
    assert p.shape == j.shape == (4, H, W)
    assert np.isfinite(p).all()
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01  # a real image, not a constant
