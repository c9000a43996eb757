"""The port's brute reference rasterizer (ops/rasterizer.rasterize, the
alpha frag mask of ops/gbuffer.py and the brute shadow-map prepass) against
the JAX package's, on the same triangle setups.

Exact: tri id, depth and bary equal on every pixel, against the reference
evaluated op by op (``jax.disable_jit()``; under jit XLA contracts the plane
evaluations into FMAs).  The port merges a block of fragments at once, the
reference one triangle at a time; the tests hold them equal on the cases of
tests/test_rasterizer.py, on cornell_box() with each depth-compare preset
and cull mode, and on random planes with forced depth ties.  A pixel-chunked
run equals an unchunked one; the brute prepass agrees with the binned one
within the reference's own bound (tests/test_rasterizer_tiled.py:19-32:
tri id differs or depth by > 1e-6 on <= 0.2% of texels).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from vulkanhybridrenderer_tpu.ops import gbuffer as jgb
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import rasterizer as jrast
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu.scene.gltf import build_scene_buffers
from vulkanhybridrenderer_tpu.utils.math3d import infinite_reverse_z_projection
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import gbuffer as pgb
from vulkanhybridrenderer_tpu_torch.ops import rasterizer as prast
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as prt
from vulkanhybridrenderer_tpu_torch.ops import shadowmap as psm

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_setup(j):
    return prast.TriangleSetup(**{f.name: _t(getattr(j, f.name))
                                  for f in dataclasses.fields(prast.TriangleSetup)})


def _clip(js, w, h, light=False):
    world = jgeo.to_world(js.buffers)
    vp = (js.light.projview if light
          else js.camera.projection(aspect=w / h) @ js.camera.view())
    return jgeo.to_clip(world.position, jnp.asarray(np.asarray(vp, np.float32)))


def _setup(js, w, h, light=False):
    clip = _clip(js, w, h, light)
    return clip, jrast.triangle_setup(clip, js.buffers.tri_vertex, w, h)


def _both(setup, w, h, mask=None, **kw):
    """(reference, port) visibility of one setup; mask: (reference frag
    mask, port frag mask)."""
    with jax.disable_jit():
        j = jrast.rasterize(setup, w, h, frag_mask_fn=None if mask is None else mask[0], **kw)
    p = prast.rasterize(_port_setup(setup), w, h, frag_mask_fn=None if mask is None else mask[1],
                        **kw)
    return j, p


def _assert_equal(j, p):
    for f in ("tri_id", "depth", "bary"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)


def _port_scene(js):
    return bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                   dataclasses.asdict(js.camera), dataclasses.asdict(js.light))


def test_single_triangle_coverage():
    """tests/test_rasterizer.py:21-48: one front-facing triangle, chunk 16;
    flipped, it is culled."""
    pos = np.array([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], np.float32)
    nrm = np.tile([[0, 0, 1]], (3, 1)).astype(np.float32)
    bufs = build_scene_buffers(
        pos, nrm, np.zeros((3, 4), np.float32), np.zeros((3, 2), np.float32),
        np.zeros((3, 2), np.float32), np.array([0, 1, 2], np.int32),
        [dict(transform=np.eye(4), vertex_offset=0, index_offset=0, index_count=3)],
    )
    proj = infinite_reverse_z_projection(np.deg2rad(60), 1.0, 0.1)
    clip = jgeo.to_clip(bufs.positions, jnp.asarray(proj))
    for tris in (bufs.tri_vertex, jnp.array([[0, 2, 1]], jnp.int32)):
        j, p = _both(jrast.triangle_setup(clip, tris, 64, 64), 64, 64, chunk=16)
        _assert_equal(j, p)
    assert (p.tri_id == -1).all()


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("compare, clear", [("greater_equal", 0.0), ("less_equal", 1.0),
                                            ("always", 0.0)])
def test_cornell_presets(compare, clear, cull):
    """cornell_box() at 64x64 with each depth-compare preset and both culls
    (the second view at 96x96, as tests/test_rasterizer.py's visibility test)."""
    js = jproc.cornell_box()
    for w in (64, 96) if compare == "greater_equal" and cull else (64,):
        _, setup = _setup(js, w, w)
        j, p = _both(setup, w, w, chunk=64, cull_backface=cull, depth_compare=compare,
                     depth_clear=clear)
        _assert_equal(j, p)
        assert (p.tri_id >= 0).float().mean() > 0.8


def test_raster_state_knobs():
    """tests/test_rasterizer.py:131-153 on the port: no culling adds
    coverage; less_equal with clear 1.0 picks the nearest surface, at most
    the reverse-Z depth wherever both cover."""
    js = jproc.cornell_box()
    _, setup = _setup(js, 64, 64)
    s = _port_setup(setup)
    cull = prast.rasterize(s, 64, 64)
    nocull = prast.rasterize(s, 64, 64, cull_backface=False)
    le = prast.rasterize(s, 64, 64, depth_compare="less_equal", depth_clear=1.0)
    assert (nocull.tri_id >= 0).sum() >= (cull.tri_id >= 0).sum()
    m = (le.tri_id >= 0) & (cull.tri_id >= 0)
    assert m.any() and bool((le.depth[m] <= cull.depth[m] + 1e-6).all())
    with pytest.raises(ValueError):
        prast.rasterize(s, 64, 64, depth_compare="greater")


@settings(max_examples=12, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), levels=st.integers(1, 3),
       compare=st.sampled_from(["greater_equal", "less_equal", "always"]))
def test_forced_depth_ties(seed, levels, compare):
    """Random overlapping triangles whose depth planes take one of `levels`
    constant values, so most covered pixels hold exact depth ties among
    several triangles: the later-submitted one must win, in every preset."""
    rng = np.random.default_rng(seed)
    t, w, h = 40, 24, 20
    xy = rng.uniform(-0.5, 1.5, (t, 3, 2)) * np.array([w, h])
    a0 = np.cross(np.concatenate([xy[:, 1], np.ones((t, 1))], 1),
                  np.concatenate([xy[:, 2], np.ones((t, 1))], 1))
    a1 = np.cross(np.concatenate([xy[:, 2], np.ones((t, 1))], 1),
                  np.concatenate([xy[:, 0], np.ones((t, 1))], 1))
    a2 = np.cross(np.concatenate([xy[:, 0], np.ones((t, 1))], 1),
                  np.concatenate([xy[:, 1], np.ones((t, 1))], 1))
    det = np.sum(np.concatenate([xy[:, 0], np.ones((t, 1))], 1) * a0, axis=1)[:, None]
    z = rng.choice(np.linspace(0.2, 0.8, levels), t)[:, None]
    planes = np.concatenate([a0 / det, a1 / det, a2 / det, np.zeros((t, 2)), z], 1)
    setup = jrast.TriangleSetup(
        planes=jnp.asarray(planes, jnp.float32), sx=jnp.zeros((t, 3)), sy=jnp.zeros((t, 3)),
        bbox=jnp.zeros((t, 4)), w_any=jnp.ones(t, bool), front=jnp.asarray(det[:, 0] < 0),
        valid=jnp.ones(t, bool))
    clear = 1.0 if compare == "less_equal" else 0.0
    j, p = _both(setup, w, h, chunk=16, cull_backface=False, depth_compare=compare,
                 depth_clear=clear)
    _assert_equal(j, p)
    covered = p.tri_id >= 0
    assert covered.any()


def test_alpha_frag_mask():
    """checker_quad(alpha_leaf=True) at 64x64 through make_alpha_frag_mask
    on both sides (tests/test_rasterizer.py:114-128): equal, and the leaf's
    alpha cuts the coverage."""
    js = jproc.checker_quad(alpha_leaf=True)
    clip, setup = _setup(js, 64, 64)
    ps = _port_scene(js)
    mask = (jgb.make_alpha_frag_mask(js.buffers, clip), pgb.make_alpha_frag_mask(ps.buffers.to("cpu")))
    j, p = _both(setup, 64, 64, mask=mask, chunk=16)
    _assert_equal(j, p)
    solid = prast.rasterize(_port_setup(setup), 64, 64, chunk=16)
    covered, covered_solid = (p.tri_id >= 0).float().mean(), (solid.tri_id >= 0).float().mean()
    assert 0.05 < covered < covered_solid * 0.9


def test_pixel_chunks_change_nothing(monkeypatch):
    """Blocks of a few rows (and chunks of 5 triangles) give the same buffer
    as one block of the whole image."""
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    _, setup = _setup(js, 96, 64)
    s = _port_setup(setup)
    whole = prast.rasterize(s, 96, 64, chunk=4096)
    monkeypatch.setattr(prast, "BRUTE_BLOCK_ELEMENTS", 5 * 96 * 3)  # 3 rows a block
    small = prast.rasterize(s, 96, 64, chunk=5)
    for f in ("tri_id", "depth", "bary"):
        assert torch.equal(getattr(whole, f), getattr(small, f)), f


def test_brute_prepass_matches_binned():
    """The brute prepass (render_shadow_map, the reference's chunk 256) and
    the binned one (K1a's plain version) on the light view of the small
    SponzaProxy at 256^2, within the reference's bound."""
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    buffers = _port_scene(js).buffers.to("cpu")
    clip = _clip(js, 256, 256, light=True)
    brute = psm.render_shadow_map(_t(clip), buffers.tri_vertex, 256, chunk=256)
    binned = prt.rasterize_scene(buffers, _t(clip), 256, 256, alpha=False)
    setup = prast.triangle_setup(_t(clip), _t(js.buffers.tri_vertex), 256, 256)
    vis = prast.rasterize(setup, 256, 256, chunk=256)
    assert torch.equal(vis.depth, brute)
    mism = (vis.tri_id != binned.tri_id) | ((vis.depth - binned.depth).abs() > 1e-6)
    assert float(mism.float().mean()) <= 0.002, float(mism.float().mean())
    assert float((brute > 0).float().mean()) > 0.3


def test_brute_forward_supersamples():
    """As in the reference (models/forward.py:40-44), coverage MSAA needs the
    binned raster: with raster="brute" the forward path supersamples, so
    msaa_mode "coverage" and "supersample" give the same frame."""
    from vulkanhybridrenderer_tpu_torch.core import config as pcfg
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
    from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

    frames = [Renderer(pproc.cornell_box(), pcfg.RenderConfig(
        width=32, height=24, shadow_map_size=64, raster="brute",
        forward=pcfg.ForwardSettings(msaa_samples=4, msaa_mode=mode)), path="forward",
        device="cpu").render_frame() for mode in ("coverage", "supersample")]
    assert torch.equal(frames[0], frames[1]) and frames[0].shape == (4, 24, 32)
