"""The port's raster stages against the JAX package on the same clip-space
vertices: triangle setup, binning, the tile raster (K1a; on the CPU its
plain PyTorch version, the JAX side the Pallas kernel in interpret mode) and
the G-buffer resolve.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.core import types as jtypes
from vulkanhybridrenderer_tpu.ops import gbuffer as jgb
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import rasterizer as jrast
from vulkanhybridrenderer_tpu.ops import rasterizer_tiled as jrt
from vulkanhybridrenderer_tpu.ops import shadetab as jtab
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import types as ptypes
from vulkanhybridrenderer_tpu_torch.ops import gbuffer as pgb
from vulkanhybridrenderer_tpu_torch.ops import rasterizer as prast
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as prt
from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab
from vulkanhybridrenderer_tpu_torch.ops.rasterizer import VisibilityBuffer

torch.set_num_threads(2)
W, H = 96, 64


def _scene(name):
    if name == "cornell":
        return jproc.cornell_box()
    return jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)


@pytest.fixture(scope="module", params=["cornell", "sponza"])
def case(request):
    """One scene through the JAX raster stages (computed once per module)."""
    js = _scene(request.param)
    view, proj = js.camera.view(), js.camera.projection(W / H)
    vp = (proj @ view).astype(np.float32)
    world = jgeo.to_world(js.buffers)
    clip = jgeo.to_clip(world.position, jnp.asarray(vp))
    setup = jrast.triangle_setup(clip, js.buffers.tri_vertex, W, H)
    bins = jrt.bin_triangles(setup, W, H, e_cap=jrt.default_e_cap(setup.sx.shape[0], W * H))
    vis = jrt.rasterize_scene(js.buffers, clip, W, H, interpret=True, alpha=False)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    return dict(js=js, ps=ps, view=view, proj=proj, world=world, clip=clip,
                setup=setup, bins=bins, vis=vis)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_triangle_setup(case):
    """Bit-equal to the reference evaluated op by op.  Under jit, XLA's CPU
    backend contracts a*b+c into FMAs (the port rounds every product, as its
    CUDA kernels do with --fmad=false); on tiny far triangles the adjugate's
    cancelling terms then differ by up to ~1e-3 of the row's magnitude, so
    the comparison runs the reference with jit disabled."""
    js = case["js"]
    with jax.disable_jit():
        j = jrast.triangle_setup(case["clip"], js.buffers.tri_vertex, W, H)
    p = prast.triangle_setup(_t(case["clip"]), _t(js.buffers.tri_vertex), W, H)
    for f in ("planes", "sx", "sy", "bbox", "w_any", "front", "valid"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)


def test_binning_matches(case):
    """Same culling and the same per-tile entry lists (tile-major, triangle
    id order inside a tile)."""
    j = case["bins"]
    assert int(np.asarray(j.overflow)[0]) == 0
    js = case["setup"]  # the same setup on both sides
    p = prt.bin_triangles(prast.TriangleSetup(**{
        f.name: _t(getattr(js, f.name)) for f in dataclasses.fields(js)}), W, H)
    ntiles = p.ntx * p.nty
    counts = np.asarray(j.counts)[:ntiles]
    np.testing.assert_array_equal(np.diff(p.offsets.numpy()), counts)
    ids = np.asarray(j.entry_data)[:, 12, :].reshape(-1)  # (nblocks*CHUNK,) tile-aligned
    offs = np.asarray(j.offsets)
    for t in range(ntiles):
        want = ids[offs[t]:offs[t] + counts[t]].astype(np.int32)
        got = p.entry_tri[p.offsets[t]:p.offsets[t + 1]].numpy()
        np.testing.assert_array_equal(got, want)
    assert p.entry_tri.shape[0] > 0


def test_visibility_buffer(case):
    js = case["js"]
    j = case["vis"]
    p = prt.rasterize_scene(case["ps"].buffers.to("cpu"), _t(case["clip"]), W, H, alpha=False)
    assert p.tri_id.dtype == torch.int32 and p.tri_id.shape == (H, W)
    jt, pt = np.asarray(j.tri_id), p.tri_id.numpy()
    agree = jt == pt
    assert agree.mean() >= 0.999, agree.mean()
    assert (pt >= 0).mean() > 0.5
    np.testing.assert_allclose(p.depth.numpy()[agree], np.asarray(j.depth)[agree], rtol=0, atol=1e-6)
    # bary 1e-5: the reference kernel's A*px + B*py + C is FMA-contracted by
    # XLA on the CPU (measured 7.6e-6 on the small Sponza proxy)
    np.testing.assert_allclose(p.bary.numpy()[agree], np.asarray(j.bary)[agree], rtol=0, atol=1e-5)
    assert js.buffers.num_triangles == case["ps"].buffers.num_triangles


def test_raster_tiles_wrapper_takes_plain_on_cpu(case):
    setup = prast.triangle_setup(_t(case["clip"]), _t(case["js"].buffers.tri_vertex), W, H)
    bins = prt.bin_triangles(setup, W, H)
    before = prt.raster_tiles.launches
    a = prt.raster_tiles(setup.planes, bins, W, H)
    b = prt.raster_tiles_plain(setup.planes, bins, W, H)
    assert prt.raster_tiles.launches == before  # no kernel launch on the CPU
    for f in ("tri_id", "depth", "bary"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    # with no entries every pixel keeps the clear values (0, -1, (0, 0, 1))
    none = prt.Bins(entry_tri=torch.zeros(0, dtype=torch.int32),
                    offsets=torch.zeros(bins.ntx * bins.nty + 1, dtype=torch.int32),
                    ntx=bins.ntx, nty=bins.nty)
    c = prt.raster_tiles(setup.planes, none, W, H)
    assert (c.tri_id == -1).all() and (c.depth == 0).all()
    assert (c.bary == torch.tensor([0.0, 0.0, 1.0])).all()


def test_resolve_gbuffer(case):
    """The resolve on identical inputs: the JAX visibility buffer, TriRows
    and shade tables go to both packages."""
    js = case["js"]
    jtabs = jtab.build_shade_tables(js.buffers)
    jrows = jtab.make_tri_rows(jtabs, js.buffers, case["world"].position, case["clip"])
    view, proj = case["view"], case["proj"]
    prev_view = view.copy()
    prev_view[2, 3] -= 0.3  # exercise the motion vectors
    jpfd = jtypes.make_per_frame_data(view, proj, js.light, W, H, 1, prev_view, proj)
    jg = jgb.resolve_gbuffer(js.buffers, jtabs, jrows, case["vis"], jpfd)

    pb = case["ps"].buffers.to("cpu")
    ptabs = ptab.ShadeTables(tri_static=_t(jtabs.tri_static), prim_rows=_t(jtabs.prim_rows),
                             atlas_q=_t(jtabs.atlas_q), atlas_w=jtabs.atlas_w)
    ppfd = ptypes.make_per_frame_data(view, proj, case["ps"].light, W, H, 1, prev_view, proj)
    vis = VisibilityBuffer(tri_id=_t(case["vis"].tri_id), depth=_t(case["vis"].depth),
                           bary=_t(case["vis"].bary))
    pg = pgb.resolve_gbuffer(pb, ptabs, _t(jrows), vis, ppfd)
    for f in ("albedo", "normal_oid", "motion_mr", "depth"):
        np.testing.assert_allclose(getattr(pg, f).numpy(), np.asarray(getattr(jg, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_apply_normal_map():
    rng = np.random.default_rng(7)
    n = rng.normal(size=(256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    tan = rng.normal(size=(256, 4)).astype(np.float32)
    tan[:, 3] = np.sign(tan[:, 3])
    ts = rng.uniform(size=(256, 3)).astype(np.float32)
    nm = np.where(np.arange(256) % 3 == 0, -1, 2).astype(np.int32)
    j = jgb.apply_normal_map(jnp.asarray(n), jnp.asarray(tan), jnp.asarray(nm), jnp.asarray(ts))
    p = pgb.apply_normal_map(_t(n), _t(tan), _t(nm), _t(ts))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
