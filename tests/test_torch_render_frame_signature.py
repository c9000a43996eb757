"""``Renderer.render_frame`` takes the reference's parameters,
``render_frame(sync=True, srgb8=False)``
(vulkanhybridrenderer_tpu/runtime/renderer.py), so a positional ``True`` is
``sync`` and ``render_frame(sync=False)``, as the reference's ``profile``
calls it, queues a frame.

The signatures are compared by name, order and default (no JAX frame is
rendered).  The frames: cornell at 32x32 on the CPU with RT shadows, AO,
reflections and SVGF, so each frame depends on the frame index and the
temporal state; whatever ``sync`` says, a renderer returns exactly the
frames of a fresh renderer at the same index.
"""
import inspect

import pytest
import torch

from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
FULL = pcfg.HybridSettings(ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED,
                           reflection_mode=pcfg.ReflectionMode.RAYTRACED, denoise=True)
CFG = pcfg.RenderConfig(width=32, height=32, alpha_raster="off", hybrid=FULL)


def _renderer():
    return prenderer.Renderer(pproc.cornell_box(), CFG, device="cpu")


@pytest.fixture(scope="module")
def fresh_frames():
    r = _renderer()
    return [r.render_frame() for _ in range(3)]


def test_parameters_equal_the_references():
    ref = inspect.signature(jrenderer.Renderer.render_frame).parameters
    got = inspect.signature(prenderer.Renderer.render_frame).parameters
    assert [(p.name, p.kind, p.default) for p in got.values()] == \
        [(p.name, p.kind, p.default) for p in ref.values()]
    assert list(got) == ["self", "sync", "srgb8"]


def test_sync_and_queued_frames_are_the_float_frame(fresh_frames):
    r = _renderer()
    synced = r.render_frame(True)
    queued = r.render_frame(sync=False)
    assert r.frame_index == 2
    for got, ref in ((synced, fresh_frames[0]), (queued, fresh_frames[1])):
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, 32, 32)
        assert torch.equal(got, ref)
    assert not torch.equal(fresh_frames[0], fresh_frames[1])


def test_positional_srgb8_is_the_uint8_image(fresh_frames):
    r = _renderer()
    r.render_frame(False)
    r.render_frame()
    img = r.render_frame(False, True)
    assert img.dtype == torch.uint8 and tuple(img.shape) == (32, 32, 4)
    assert torch.equal(img, prenderer._encode_srgb8(fresh_frames[2]))
