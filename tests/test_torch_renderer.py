"""The port's renderer extras (runtime/renderer.py, runtime/camera.py):
the fly camera against the JAX package's, ``set_path``, one render graph per
(path, config), and the temporal state at trace resolution.

The camera: the same moves and mouse-looks on both packages' cameras, from
the same scene arrays; position, yaw and pitch exactly equal (both run the
same float32 numpy arithmetic; measured equal).  The frames: cornell at
32x32 on the CPU; a path switched to with ``set_path`` renders exactly the
frame of a renderer built on that path.
"""
import dataclasses

import numpy as np
import torch

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
MOVES = [
    (0.016, {"w"}, (0.0, 0.0), False),
    (0.033, {"a", "s"}, (12.0, -5.0), True),
    (0.020, {"d"}, (0.0, 0.0), True),  # mouse down without a delta: no turn
    (0.5, set(), (0.0, 400.0), True),  # pitch clamped at -1.55
    (0.1, {"w", "d"}, (-3.0, 2.0), False),  # a delta without the button: no turn
]


def test_update_camera_matches_jax():
    js = jproc.cornell_box()
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(width=32, height=32), path="hybrid")
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(width=32, height=32, alpha_raster="off"),
                            device="cpu")
    for dt, keys, mouse, down in MOVES:
        jr.update_camera(dt, keys=keys, mouse_delta=mouse, mouse_down=down)
        pr.update_camera(dt, keys=keys, mouse_delta=mouse, mouse_down=down)
        jc, pc = jr.scene.camera, pr.scene.camera
        np.testing.assert_array_equal(pc.position, jc.position)
        assert (pc.yaw, pc.pitch) == (jc.yaw, jc.pitch)
        assert pc.position.dtype == np.float32
    assert pr.scene.camera.pitch == -1.55
    np.testing.assert_array_equal(pr.scene.camera.view(), jr.scene.camera.view())


def test_set_path_and_one_graph_per_path_and_config():
    cfg = pcfg.RenderConfig(width=32, height=32, alpha_raster="off")
    r = prenderer.Renderer(pproc.cornell_box(), cfg, device="cpu")
    hybrid_graph = r.graph
    r.set_path("raytraced")
    assert r.path_name == "raytraced" and "Raytrace Pass" in r.graph.find_execution_order()
    img = r.render_frame()
    ref = prenderer.Renderer(pproc.cornell_box(), cfg, path="raytraced",
                             device="cpu").render_frame()
    assert torch.equal(img, ref)
    r.set_path("rayquery")
    r.set_path("hybrid")
    assert r.graph is hybrid_graph  # built once, reused
    assert len(r._graphs) == 3
    half = dataclasses.replace(cfg, hybrid=pcfg.HybridSettings(rt_scale=2))
    r.set_config(half)
    half_graph = r.graph
    assert "RT Upsample Pass" in half_graph.find_execution_order()
    r.set_config(cfg)
    assert r.graph is hybrid_graph
    r.set_config(half)
    assert r.graph is half_graph and len(r._graphs) == 4


def test_temporal_state_at_trace_resolution():
    full = pcfg.HybridSettings(ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED, denoise=True)
    cfg = pcfg.RenderConfig(width=33, height=21, alpha_raster="off", hybrid=full)
    r = prenderer.Renderer(pproc.cornell_box(), cfg, device="cpu")
    assert r.temporal_state.shadow_ao_history.shape == (2, 21, 33)
    r.render_frame()
    kept = r.temporal_state
    r.set_config(dataclasses.replace(cfg, ao_rays=1))  # same size: history kept
    assert r.temporal_state is kept
    r.set_config(dataclasses.replace(cfg, hybrid=dataclasses.replace(full, rt_scale=2)))
    assert r.temporal_state.shadow_ao_history.shape == (2, 11, 17)
    img = r.render_frame()
    assert img.shape == (4, 21, 33) and bool(torch.isfinite(img).all())
    assert r.temporal_state.shadow_ao_history.shape == (2, 11, 17)
