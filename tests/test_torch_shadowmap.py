"""The port's shadow map (the Depth Prepass: every triangle through K1a, on
the CPU its plain version) and its lookups against the JAX package.

Tolerances: the prepass depth within 1e-4 on >= 99.9% of texels (measured:
every texel within 5.2e-5, and 98.7% within 1e-6).  The port's triangle
setup equals the reference's run op by op bit for bit; jitted, XLA contracts
its multiply-adds into FMAs, and the light's orthographic z plane has
constants up to ~77 that cancel to depths near 0.5, which carries those
roundings into the fifth decimal.  shadow_coords within 1e-6 (measured
1.2e-7).  The PCF and single-tap results are hard compares of those
coordinates against the map, so they must be equal on >= 99.9% of points
(measured: every point equal): XLA computes the light transform as a dot,
the port as multiply-adds in a fixed order, which can move a coordinate by
an ulp and flip one tap.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.models import passes as jpasses
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import shadowmap as jsm
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RenderGraph
from vulkanhybridrenderer_tpu_torch.models import passes as ppasses
from vulkanhybridrenderer_tpu_torch.ops import shadowmap as psm
from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab
from vulkanhybridrenderer_tpu_torch.core import types as ptypes

torch.set_num_threads(2)
S = 128


@pytest.fixture(scope="module")
def sponza():
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    world = jgeo.to_world(js.buffers).position
    light_clip = jgeo.to_clip(world, js.light.projview)
    j = jpasses.rasterize_for_path(
        js.buffers, light_clip, S, S, jcfg.RenderConfig(shadow_map_size=S), alpha=False)
    # world points to look up: the scene's own vertices, nudged off their
    # surfaces both ways, and random points inside its bounds
    gen = np.random.default_rng(11)
    verts = np.asarray(world)
    lo, hi = verts.min(0), verts.max(0)
    pts = np.concatenate([
        verts + gen.normal(scale=0.05, size=verts.shape),
        gen.uniform(lo, hi, size=(4096, 3)),
    ]).astype(np.float32)
    return dict(js=js, ps=ps, jdepth=np.array(j.depth), pts=pts,
                projview=np.array(js.light.projview, np.float32))


def test_prepass_depth_matches_jax(sponza):
    """The port's Depth Prepass through its graph (Geometry's LightClip, then
    the binned raster with alpha off) against the JAX prepass raster."""
    ps = sponza["ps"]
    pb = ps.buffers.to("cpu")
    g = RenderGraph()
    ppasses.add_geometry_pass(g)
    ppasses.add_shadow_map_pass(g, S, pcfg.RenderConfig(shadow_map_size=S))
    g.add_pass("out", lambda res: {"RENDER_OUTPUT": res["Shadow Map"]},
               inputs=("Shadow Map",), outputs=("RENDER_OUTPUT",))
    cam = ps.camera
    pfd = ptypes.make_per_frame_data(cam.view(), cam.projection(1.0), ps.light, S, S)
    res = g.run({"scene": pb, "pfd": pfd, "prim_transform": pb.prim_transform,
                 "shade_tables": ptab.build_shade_tables(pb)})
    got, want = res["Shadow Map"].numpy(), sponza["jdepth"]
    assert got.shape == (S, S)
    assert (want > 0).mean() > 0.3  # the map sees the scene
    close = np.abs(got - want) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(got - want).max())


def test_shadow_coords_match_jax(sponza):
    pts, pv = sponza["pts"], sponza["projview"]
    j = np.asarray(jsm.shadow_coords(jnp.asarray(pv), jnp.asarray(pts)))
    p = psm.shadow_coords(torch.from_numpy(pv), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)


def _lookup_maps(sponza):
    """The prepass map (the <= 4096 branch) and a random 16 x 4100 map (the
    per-tap branch above 4096 texels a side)."""
    gen = np.random.default_rng(5)
    wide = gen.uniform(0.0, 1.0, size=(16, 4100)).astype(np.float32)
    return {"prepass": sponza["jdepth"], "wide": wide}


@pytest.mark.parametrize("which", ["prepass", "wide"])
def test_pcf16_matches_jax(sponza, which):
    sm = _lookup_maps(sponza)[which]
    pts, pv = sponza["pts"], sponza["projview"]
    j = np.asarray(jsm.shadow_pcf16(jnp.asarray(sm), jnp.asarray(pv), jnp.asarray(pts)))
    p = psm.shadow_pcf16(torch.from_numpy(sm), torch.from_numpy(pv),
                         torch.from_numpy(pts)).numpy()
    assert p.shape == (pts.shape[0],)
    equal = p == j
    assert equal.mean() >= 0.999, (equal.mean(), np.abs(p - j).max())
    assert 0.0 < (p == 1.0).mean() < 1.0 and ((p > 0.0) & (p < 1.0)).any()  # partial taps


def test_single_tap_matches_jax(sponza):
    sm, pts, pv = sponza["jdepth"], sponza["pts"], sponza["projview"]
    j = np.asarray(jsm.shadow_single_tap(jnp.asarray(sm), jnp.asarray(pv), jnp.asarray(pts)))
    p = psm.shadow_single_tap(torch.from_numpy(sm), torch.from_numpy(pv),
                              torch.from_numpy(pts)).numpy()
    assert (p == j).mean() >= 0.999
    assert 0.0 < p.mean() < 1.0


@pytest.mark.parametrize("h,w", [(100, 100), (16, 4096)])
def test_pcf_on_patterned_maps(h, w):
    """The <= 4096 branch on checkerboard maps, where which texel each tap
    reads decides the result: each row of taps comes from the 4-texel run
    at x0 = floor(fx - 1.5 * w / 4096), clamped into the map, and tap x reads
    texel x0 + clip(xi - x0, 0, 3) (at w = 4096 the taps span the whole
    run).  Points spread past the map's edges."""
    yy, xx = np.mgrid[:h, :w]
    sm = ((xx + yy) % 2).astype(np.float32)
    gen = np.random.default_rng(2)
    # light space = identity: uv = xy * 0.5 + 0.5 (bias matrix), depth = z
    pv = np.eye(4, dtype=np.float32)
    pts = np.stack([gen.uniform(-1.1, 1.1, 4096), gen.uniform(-1.1, 1.1, 4096),
                    gen.uniform(0.2, 0.8, 4096)], -1).astype(np.float32)
    j = np.asarray(jsm.shadow_pcf16(jnp.asarray(sm), jnp.asarray(pv), jnp.asarray(pts)))
    p = psm.shadow_pcf16(torch.from_numpy(sm), torch.from_numpy(pv),
                         torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(p, j)
    assert len(np.unique(p)) > 2
