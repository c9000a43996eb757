"""The reference's calls that only name TPU machinery run on the port:
``RenderGraph.time_passes(resources, target, iters)`` without a device;
``interpret=`` on rasterize_scene, rasterize_scene_msaa and
rasterize_alpha_peeled; ``strips=`` and ``hit_filter=`` on
shadowgrid.trace_shadow; bin_triangles' ``tile_h``, ``tile_w``,
``exclude_mask`` and ``tri_ids``; math3d's ``axis=`` / ``keepdims=``.

Each is accepted with the result of the call without it (equal bit for
bit), or, where it has a meaning, with the reference's result: the grid
trace's hit mask against the JAX trace_shadow with the same keywords, the
binning's overflow against the JAX bin_triangles', math3d against jnp
within 1e-6.  Parameter names, order and defaults equal the reference's by
inspect.signature, up to the port's trailing keywords.  Scenes:
cornell_box() and checker_quad(alpha_leaf=True) at 96x64.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.graph import render_graph as jgraph
from vulkanhybridrenderer_tpu.ops import bvh as jbvh
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import rasterizer as jrast
from vulkanhybridrenderer_tpu.ops import rasterizer_tiled as jrt
from vulkanhybridrenderer_tpu.ops import shadowgrid as jsg
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu.utils import math3d as jm
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.graph import render_graph as pgraph
from vulkanhybridrenderer_tpu_torch.ops import rasterizer as prast
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as prt
from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab
from vulkanhybridrenderer_tpu_torch.ops import shadowgrid as psg
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav
from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc
from vulkanhybridrenderer_tpu_torch.utils import math3d as pm

torch.set_num_threads(2)
W, H = 96, 64

# (reference function, port function, the port's trailing keywords)
SIGNATURES = {
    "time_passes": (jgraph.RenderGraph.time_passes, pgraph.RenderGraph.time_passes, []),
    "rasterize_scene": (jrt.rasterize_scene, prt.rasterize_scene, []),
    "rasterize_scene_msaa": (jrt.rasterize_scene_msaa, prt.rasterize_scene_msaa, []),
    "rasterize_alpha_peeled": (jrt.rasterize_alpha_peeled, prt.rasterize_alpha_peeled,
                               ["trace"]),
    "bin_triangles": (jrt.bin_triangles, prt.bin_triangles, ["include"]),
    "trace_shadow": (jsg.trace_shadow, psg.trace_shadow, ["alpha_tables", "width",
                                                          "stage_rows"]),
    "dot": (jm.dot, pm.dot, []),
    "normalize": (jm.normalize, pm.normalize, []),
}


@pytest.mark.parametrize("name", list(SIGNATURES))
def test_signature_matches_reference(name):
    ref_fn, port_fn, trailing = SIGNATURES[name]
    ref = list(inspect.signature(ref_fn).parameters.values())
    port = list(inspect.signature(port_fn).parameters.values())
    assert [(p.name, p.default) for p in port[:len(ref)]] == [(p.name, p.default) for p in ref]
    assert [p.name for p in port[len(ref):]] == trailing
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY for p in port[len(ref):])


def _port_scene(js):
    return bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                   dataclasses.asdict(js.camera), dataclasses.asdict(js.light))


@pytest.fixture(scope="module")
def checker():
    js = jproc.checker_quad(alpha_leaf=True)
    ps = _port_scene(js)
    pb = ps.buffers.to("cpu")
    world = jgeo.to_world(js.buffers)
    vp = js.camera.projection(aspect=W / H) @ js.camera.view()
    clip = np.array(jgeo.to_clip(world.position, jnp.asarray(np.asarray(vp, np.float32))))
    return dict(js=js, pb=pb, clip=clip, pclip=torch.from_numpy(clip),
                tables=ptab.build_shade_tables(pb))


def _equal_vis(a, b):
    for f in ("tri_id", "depth", "bary"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_time_passes_reference_calls():
    """graph.time_passes(res, iters=...) as the reference's renderer calls
    it, and a positional target and iters: the device is the resources'."""
    hs = pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.RASTERIZED,
                             ao_mode=pcfg.AmbientOcclusionMode.SSAO)
    r = Renderer(pproc.cornell_box(), pcfg.RenderConfig(width=W, height=H, shadow_map_size=128,
                                                        alpha_raster="off", hybrid=hs),
                 device="cpu")
    res = r._resources(r._make_pfd())
    full = r.graph.time_passes(res, iters=1)
    assert list(full) == r.graph.find_execution_order()
    depth = r.graph.time_passes(res, "Depth", 2)
    assert list(depth) == r.graph.find_execution_order("Depth")
    assert "SSAO Pass" in full and "SSAO Pass" not in depth
    assert all(v >= 0.0 for v in (*full.values(), *depth.values()))


@pytest.mark.parametrize("interpret", [True, False, None])
def test_interpret_is_accepted(checker, interpret):
    c = checker
    base = prt.rasterize_scene(c["pb"], c["pclip"], W, H, tables=c["tables"])
    _equal_vis(prt.rasterize_scene(c["pb"], c["pclip"], W, H, interpret, tables=c["tables"]),
               base)
    for a, b in zip(prt.rasterize_scene_msaa(c["pb"], c["pclip"], W, H, 4, interpret,
                                             tables=c["tables"]),
                    prt.rasterize_scene_msaa(c["pb"], c["pclip"], W, H, 4, tables=c["tables"])):
        _equal_vis(a, b)
    setup = prast.triangle_setup(c["pclip"], c["pb"].tri_vertex, W, H)
    # the reference's positional order after rounds: interpret, cull_backface
    got, ov = prt.rasterize_alpha_peeled(c["pb"], setup, W, H, c["tables"], 4, interpret, True,
                                         prt.TILE_H, prt.TILE_W, False, False, 16, 16)
    want, ov2 = prt.rasterize_alpha_peeled(c["pb"], setup, W, H, c["tables"])
    _equal_vis(got, want)
    assert torch.equal(ov, ov2)


def test_other_tiles_raise(checker):
    c = checker
    setup = prast.triangle_setup(c["pclip"], c["pb"].tri_vertex, W, H)
    for call in (lambda: prt.rasterize_scene(c["pb"], c["pclip"], W, H, None, 16, 128),
                 lambda: prt.bin_triangles(setup, W, H, 8, 64),
                 lambda: prt.rasterize_alpha_peeled(c["pb"], setup, W, H, c["tables"],
                                                    tile_w=256)):
        with pytest.raises(ValueError, match="tiles are 8x128"):
            call()


def test_bin_triangles_reference_keywords():
    """exclude_mask is include's negation; tri_ids names a subset's entries
    by their global ids (the reference's alpha stream), which equals binning
    the whole setup with the subset included; the overflow is the
    reference's for the same call."""
    js = jproc.cornell_box()
    world = jgeo.to_world(js.buffers)
    vp = js.camera.projection(aspect=W / H) @ js.camera.view()
    clip = jgeo.to_clip(world.position, jnp.asarray(np.asarray(vp, np.float32)))
    jsetup = jrast.triangle_setup(clip, js.buffers.tri_vertex, W, H)
    setup = prast.TriangleSetup(**{f.name: torch.tensor(np.array(getattr(jsetup, f.name)))
                                   for f in dataclasses.fields(prast.TriangleSetup)})
    t = setup.planes.shape[0]
    exclude = torch.arange(t) % 3 == 0
    cap = prt.default_e_cap(t, W * H)
    a = prt.bin_triangles(setup, W, H, prt.TILE_H, prt.TILE_W, cap, True, exclude, None)
    b = prt.bin_triangles(setup, W, H, e_cap=cap, include=~exclude)
    assert torch.equal(a.entry_tri, b.entry_tri) and torch.equal(a.offsets, b.offsets)
    j = jrt.bin_triangles(jsetup, W, H, jrt.TILE_H, jrt.TILE_W, 64, True,
                          jnp.asarray(exclude.numpy()), None)
    small = prt.bin_triangles(setup, W, H, prt.TILE_H, prt.TILE_W, 64, True, exclude, None)
    assert small.overflow.tolist() == np.asarray(j.overflow).tolist() and small.overflow[0] > 0
    ids = torch.nonzero(~exclude).squeeze(1)
    sub = prast.TriangleSetup(**{f.name: getattr(setup, f.name)[ids]
                                 for f in dataclasses.fields(prast.TriangleSetup)})
    c = prt.bin_triangles(sub, W, H, e_cap=cap, tri_ids=ids.to(torch.int32))
    assert torch.equal(c.entry_tri, a.entry_tri) and torch.equal(c.offsets, a.offsets)
    assert int(a.offsets[-1]) > 0


def test_trace_shadow_reference_keywords():
    """strips (positional after hit_filter, as the reference's) changes no
    hit; hit_filter=make_alpha_hit_filter(...) filters as alpha_tables does;
    both masks equal the JAX trace_shadow's with the same keywords."""
    js = jproc.checker_quad(alpha_leaf=True)
    pb = _port_scene(js).buffers.to("cpu")
    world = jgeo.to_world(js.buffers)
    tris = np.array(jbvh.world_triangles(world.position, js.buffers.tri_vertex))
    rng = np.random.default_rng(3)
    n = 512
    o = np.stack([rng.uniform(-2.5, 2.5, n), np.full(n, -0.5), rng.uniform(-2.5, 2.5, n)], -1)
    light = np.array([0.0, -1.0, 0.0], np.float32)
    d = np.tile(-light, (n, 1))
    jg = jsg.build_shadow_grid(jnp.asarray(tris), jnp.asarray(light))
    pg = psg.build_shadow_grid(torch.from_numpy(tris), torch.from_numpy(light))
    po, pd = torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
    base = psg.trace_shadow(pg, po, pd, 0.01, 1e4)
    assert torch.equal(psg.trace_shadow(pg, po, pd, 0.01, 1e4, None, 64), base)
    want = jsg.trace_shadow(jg, jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32), 0.01,
                            1e4, None, 64)
    np.testing.assert_array_equal(base.numpy(), np.asarray(want))
    filt = ptrav.make_alpha_hit_filter(pb)
    got = psg.trace_shadow(pg, po, pd, 0.01, 1e4, filt, 16)
    assert torch.equal(got, psg.trace_shadow(pg, po, pd, 0.01, 1e4, alpha_tables=filt.tables))
    want = jsg.trace_shadow(jg, jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32), 0.01,
                            1e4, hit_filter=jtrav.make_alpha_hit_filter(js.buffers), strips=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(base.sum())
    with pytest.raises(ValueError, match="make_alpha_hit_filter"):
        psg.trace_shadow(pg, po, pd, 0.01, 1e4, lambda tri, u, v, cand: cand)


def test_math3d_axis_keepdims():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(3, 5)).astype(np.float32), rng.normal(size=(3, 5)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for axis in (0, -1):
        for keep in (False, True):
            got = pm.dot(ta, tb, axis=axis, keepdims=keep)
            want = np.asarray(jm.dot(jnp.asarray(a), jnp.asarray(b), axis=axis, keepdims=keep))
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        got = pm.normalize(ta, axis=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(jm.normalize(jnp.asarray(a), axis=axis)),
                                   rtol=1e-6, atol=1e-6)
    assert torch.equal(pm.dot(ta, tb, 0, True), pm.dot(ta, tb, axis=0, keepdims=True))
