"""``models/passes.add_shadow_map_pass(graph, size)`` called as the
reference's is, with no config: both packages take the brute prepass (the
reference's ``models/passes.py:82-95``), run through each package's render
graph after its Geometry pass on cornell_box at 64x64.

Tolerance: that of ``test_torch_shadowmap.py``, depth within 1e-4 on >=
99.9% of texels (measured: 285 of 4,096 texels differ, by up to 1.5e-5:
XLA contracts the reference's jitted light-space setup into FMAs, the port
rounds every product).  ~40 s alone, most of it the reference's brute
raster.
"""
import dataclasses
import inspect

import numpy as np
import torch

from vulkanhybridrenderer_tpu.core import types as jtypes
from vulkanhybridrenderer_tpu.graph.render_graph import RenderGraph as JRenderGraph
from vulkanhybridrenderer_tpu.models import passes as jpasses
from vulkanhybridrenderer_tpu.ops import shadetab as jtab
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import types as ptypes
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RenderGraph
from vulkanhybridrenderer_tpu_torch.models import passes as ppasses
from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab

torch.set_num_threads(2)


def test_add_shadow_map_pass_without_config_is_brute():
    """add_shadow_map_pass(graph, size) with no config: both packages take
    the brute prepass; the maps are equal."""
    size = 64
    js = jproc.cornell_box()
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    assert (inspect.signature(ppasses.add_shadow_map_pass).parameters["config"].default
            is inspect.signature(jpasses.add_shadow_map_pass).parameters["config"].default is None)
    view, proj = js.camera.view(), js.camera.projection(1.0)

    jg = JRenderGraph()
    jpasses.add_geometry_pass(jg)
    jpasses.add_shadow_map_pass(jg, size)
    jg.add_pass("out", lambda res: {"RENDER_OUTPUT": res["Shadow Map"]},
                inputs=("Shadow Map",), outputs=("RENDER_OUTPUT",))
    jres = jg.run({"scene": js.buffers, "prim_transform": js.buffers.prim_transform,
                   "pfd": jtypes.make_per_frame_data(view, proj, js.light, size, size),
                   "shade_tables": jtab.build_shade_tables(js.buffers)})

    pb = ps.buffers.to("cpu")
    pg = RenderGraph()
    ppasses.add_geometry_pass(pg)
    ppasses.add_shadow_map_pass(pg, size)
    pg.add_pass("out", lambda res: {"RENDER_OUTPUT": res["Shadow Map"]},
                inputs=("Shadow Map",), outputs=("RENDER_OUTPUT",))
    pres = pg.run({"scene": pb, "prim_transform": pb.prim_transform,
                   "pfd": ptypes.make_per_frame_data(view, proj, ps.light, size, size),
                   "shade_tables": ptab.build_shade_tables(pb)})
    got, want = pres["Shadow Map"].numpy(), np.asarray(jres["Shadow Map"])
    assert got.shape == (size, size) and (want > 0).mean() > 0.05
    close = np.abs(got - want) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(got - want).max())
