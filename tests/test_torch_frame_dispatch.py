"""The port's frame dispatch: Renderer(dispatch="fused" | "per_pass",
auto_precompile), precompile_passes and RenderGraph.make_frame_fn, with the
reference's two tests (tests/test_hybrid_path.py:144-183) ported onto the
port, on the CPU (where both modes call the frame function directly; the
CUDA graphs they capture on a card are held equal to eager frames by
chip_smoke.py).  The one JAX comparison here is the constructor's
signature; the frame against the JAX renderer is
test_torch_frame_dispatch_jax.py.

Tolerance: none.  The reference allows atol 2e-5 between its fused and
per-pass frames because XLA contracts across a fused frame; the port runs
the same PyTorch ops either way, so the frames are equal bit for bit.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.core import types as ptypes
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT
from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc
from vulkanhybridrenderer_tpu_torch.utils import rng

torch.set_num_threads(2)
W, H = 96, 64


def _cfg(hs):
    return pcfg.RenderConfig(width=W, height=H, shadow_map_size=128, alpha_raster="off",
                             hybrid=hs)


def test_per_pass_dispatch_matches_fused():
    """dispatch="per_pass" gives the fused frame, with the temporal state
    carried across frames (SVGF's history through the per-pass resources)."""
    sc = pproc.cornell_box()
    hs = pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.RAYTRACED,
                             ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED, denoise=True)
    ra = Renderer(sc, _cfg(hs), path="hybrid", device="cpu")
    rb = Renderer(sc, _cfg(hs), path="hybrid", dispatch="per_pass", device="cpu")
    assert (ra.dispatch, rb.dispatch) == ("fused", "per_pass")
    frames = []
    for _ in range(2):
        img_a, img_b = ra.render_frame(), rb.render_frame()
        assert torch.equal(img_a, img_b)
        frames.append(img_a)
    assert not torch.equal(frames[0], frames[1])  # the history and the noise moved
    for f in dataclasses.fields(ra.temporal_state):
        assert torch.equal(getattr(ra.temporal_state, f.name), getattr(rb.temporal_state, f.name))


def test_precompile_passes_aot():
    """precompile_passes returns a value for every pass of the execution
    order (0.0 on the CPU, where nothing is built) and the two dunder keys;
    the precompiled per-pass frames equal the lazy ones and the fused."""
    sc = pproc.cornell_box()
    hs = pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.RAYTRACED, denoise=True)
    ra = Renderer(sc, _cfg(hs), path="hybrid", dispatch="per_pass", auto_precompile=False,
                  device="cpu")
    rb = Renderer(sc, _cfg(hs), path="hybrid", dispatch="per_pass", device="cpu")
    rc = Renderer(sc, _cfg(hs), path="hybrid", device="cpu")
    times = rb.precompile_passes()
    order = rb.graph.find_execution_order()
    assert set(order) <= set(times)
    assert set(times) - set(order) == {"__trace_s__", "__wall_s__"}
    assert all(times[n] == 0.0 for n in order)
    assert rb.frame_index == 0 and rb._prev_view is None  # nothing advanced
    for _ in range(2):
        img_a, img_b, img_c = ra.render_frame(), rb.render_frame(), rc.render_frame()
        assert torch.equal(img_a, img_b) and torch.equal(img_a, img_c)


def test_renderer_signature_matches_reference():
    """The reference's parameters and defaults in its order, then the
    port's own `device` last."""
    ref = list(inspect.signature(jrenderer.Renderer.__init__).parameters.values())
    port = list(inspect.signature(Renderer.__init__).parameters.values())
    assert [(p.name, p.default) for p in port[:len(ref)]] == [(p.name, p.default) for p in ref]
    assert ref[-1].name == "auto_precompile"
    assert [p.name for p in port[len(ref):]] == ["device"] and port[-1].default is None
    r = Renderer(pproc.cornell_box(), _cfg(pcfg.HybridSettings()), "hybrid", None, "per_pass",
                 False, "cpu")
    assert (r.dispatch, r.auto_precompile, r.device.type) == ("per_pass", False, "cpu")


@pytest.mark.parametrize("dispatch", ["bogus", "FUSED", None])
def test_unknown_dispatch_raises(dispatch):
    with pytest.raises(ValueError, match="'fused' or 'per_pass'"):
        Renderer(pproc.cornell_box(), _cfg(pcfg.HybridSettings()), dispatch=dispatch,
                 device="cpu")


def _leaves(x):
    if dataclasses.is_dataclass(x):
        return [getattr(x, f.name) for f in dataclasses.fields(x)]
    return [x]


def test_make_frame_fn_returns_target_and_keep():
    """make_frame_fn(target, keep) returns exactly target + keep, equal to
    graph.run's resources of the same names."""
    hs = pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.RAYTRACED, denoise=True)
    r = Renderer(pproc.cornell_box(), _cfg(hs), device="cpu")
    pfd = r._make_pfd()
    full = r.graph.run(r._resources(pfd))
    for keep in ((), ("TemporalStateOut",), ("Depth", "Albedo")):
        out = r.graph.make_frame_fn(RENDER_OUTPUT, keep=keep)(r._resources(pfd))
        assert list(out) == [RENDER_OUTPUT, *keep]
        for k in out:
            assert all(torch.equal(a, b) for a, b in zip(_leaves(out[k]), _leaves(full[k])))
    depth = r.graph.make_frame_fn("Depth")(r._resources(pfd))
    assert list(depth) == ["Depth"] and torch.equal(depth["Depth"], full["Depth"])


@pytest.mark.parametrize("path", ["forward", "raytraced", "rayquery"])
def test_auto_precompile_off_gives_the_fused_frame(path):
    """Every path: per_pass without auto_precompile renders the fused frame."""
    sc = pproc.cornell_box()
    cfg = _cfg(pcfg.HybridSettings())
    a = Renderer(sc, cfg, path=path, device="cpu")
    b = Renderer(sc, cfg, path=path, dispatch="per_pass", auto_precompile=False, device="cpu")
    for _ in range(2):
        assert torch.equal(a.render_frame(), b.render_frame())


def test_add_pass_signature_matches_reference():
    """RenderGraph.add_pass takes the reference's parameters in its order
    and nothing else: no pass is declared apart for the capture, since
    every pass sizes its work from shapes alone."""
    from vulkanhybridrenderer_tpu.graph import render_graph as jgraph
    from vulkanhybridrenderer_tpu_torch.graph import render_graph as pgraph

    ref = inspect.signature(jgraph.RenderGraph.add_pass).parameters
    port = inspect.signature(pgraph.RenderGraph.add_pass).parameters
    assert list(port) == list(ref) == ["self", "name", "fn", "inputs", "outputs"]
    assert [f.name for f in dataclasses.fields(pgraph.Pass)] == [
        "name", "fn", "inputs", "outputs"]


def _animate(r, f):
    r.animate(pproc.animate_pica(r.scene, f / 4.0))


@pytest.mark.parametrize("case", ["brute", "animated grid"])
def test_static_passes_fused_equals_per_pass(case):
    """The two kinds of pass once sized on the host, now sized statically:
    the brute raster (G-Buffer Pass and Depth Prepass) and the animated
    grid's rebuild with the Raytrace Pass that reads it.  Fused and
    per_pass frames are equal over 3 frames, the temporal state carried and
    the scene moved between frames."""
    if case == "brute":
        sc = pproc.cornell_box()
        hs = pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.RASTERIZED,
                                 ao_mode=pcfg.AmbientOcclusionMode.SSAO)
        cfg, step = dataclasses.replace(_cfg(hs), raster="brute"), None
    else:
        sc = pproc.pica_proxy()
        hs = pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.RAYTRACED,
                                 ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED, denoise=True)
        cfg = dataclasses.replace(_cfg(hs), shadow_accel="grid", animated=True)
        step = _animate
    ra = Renderer(sc, cfg, device="cpu")
    rb = Renderer(sc, cfg, dispatch="per_pass", device="cpu")
    frames = []
    for f in range(3):
        for r in (ra, rb):
            if step is not None:
                step(r, f)
        img_a, img_b = ra.render_frame(), rb.render_frame()
        assert torch.equal(img_a, img_b) and bool(torch.isfinite(img_a).all())
        frames.append(img_a)
    assert not torch.equal(frames[1], frames[2]) or step is None
    if step is not None:
        assert "Shadow Grid Build" in ra.graph.find_execution_order()


@pytest.mark.parametrize("frame", [0, 1, 7, 2**31 + 5, 2**32 - 1])
def test_frame_index_tensor_gives_the_int_seeds(frame):
    """PerFrameData carries the frame index as a () int64 tensor (a captured
    frame reads it, so a replay does not freeze the noise); pixel_seed
    gives the int's seeds bit for bit."""
    view, proj = np.eye(4, dtype=np.float32), np.diag([1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    pfd = ptypes.make_per_frame_data(view, proj, pproc.cornell_box().light, W, H,
                                     frame_index=frame)
    assert pfd.frame_index.dtype == torch.int64 and pfd.frame_index.shape == ()
    assert int(pfd.frame_index) == frame & 0xFFFFFFFF and int(pfd.blue_noise_index) == frame % 4
    assert torch.equal(rng.pixel_seed(W, H, pfd.frame_index), rng.pixel_seed(W, H, frame))
    assert torch.equal(rng.pixel_seed(W, H, torch.tensor(frame, dtype=torch.int64)),
                       rng.pixel_seed(W, H, frame))


class _StubFrame:
    """Stands in for dispatch.CapturedFrame (which needs a card): records
    its key and whether it was released."""

    def __init__(self, key, *args):
        self.key, self.released = key, 0

    def matches(self, consts):
        return True

    def release(self):
        self.released += 1


def test_one_captured_frame_at_a_time(monkeypatch):
    """A renderer keeps the active key's captured frame only: a viewer
    slider drag (a config a value, per_pass as the viewer runs it) releases
    each value's frame, once, when the next value's is made, so the device
    memory the frames pin cannot grow with the values dragged over;
    switching dispatch mode or path does the same."""
    from vulkanhybridrenderer_tpu_torch.runtime import dispatch as pdispatch
    from vulkanhybridrenderer_tpu_torch.runtime.viewer import ViewerState

    monkeypatch.setattr(pdispatch, "CapturedFrame", _StubFrame)
    raster = pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.RASTERIZED,
                                 ao_mode=pcfg.AmbientOcclusionMode.SSAO)
    state = ViewerState(pproc.cornell_box(), _cfg(raster), "hybrid", device="cpu")
    r = state.renderer
    made = []
    for value in (0.3, 0.4, 0.5, 0.6, 0.5, 0.3):
        state.set_param("ssao_radius", value)
        made.append(r._captured_frame(per_pass=True))
        assert r._captured is made[-1] and made[-1].key == ("per_pass", "hybrid", r.config)
    assert r._captured_frame(per_pass=True) is made[-1]  # the same key: kept
    assert [f.released for f in made] == [1] * 5 + [0]
    fused = r._captured_frame(per_pass=False)
    r.set_path("forward")
    fwd = r._captured_frame(per_pass=False)
    assert (made[-1].released, fused.released, fwd.released) == (1, 1, 0)
    assert r._captured is fwd and fwd.key == ("fused", "forward", r.config)


@pytest.mark.cuda
def test_slider_drag_does_not_grow_device_memory():
    """On a card: dragging the viewer's ssao_radius slider over 8 values
    (each value a config, captured per pass) leaves the device memory the
    caching allocator holds where the second value left it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vulkanhybridrenderer_tpu_torch.runtime.viewer import ViewerState

    raster = pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.RASTERIZED,
                                 ao_mode=pcfg.AmbientOcclusionMode.SSAO)
    cfg = dataclasses.replace(_cfg(raster), width=640, height=360)
    state = ViewerState(pproc.cornell_box(), cfg, "hybrid", device="cuda")
    reserved = []
    for i in range(8):
        state.set_param("ssao_radius", 0.3 + 0.05 * i)
        state.renderer.render_frame()
        reserved.append(torch.cuda.memory_reserved())
    assert max(reserved[2:]) <= reserved[1], reserved
